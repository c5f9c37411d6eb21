from .props import PhysicalProps  # noqa: F401
from .table import FlatBag, StringEncoder, concat_bags  # noqa: F401
