# The shredded query compiler: NRC, shredding, materialization, plans,
# unnesting and code generation (mirrors repro.core).
