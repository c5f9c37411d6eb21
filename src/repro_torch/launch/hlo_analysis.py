"""Post-SPMD HLO analysis with while-loop trip-count scaling.

``compiled.cost_analysis()`` counts each while body ONCE, so a scanned
95-layer model reports ~1 layer of FLOPs. XLA annotates rolled loops
with ``backend_config={"known_trip_count":{"n":...}}``; this module
parses the partitioned HLO text, builds the computation call graph
(entry -> while bodies -> fusions), multiplies each computation by its
loop-nest trip product, and derives:

  * dot_flops        — 2 x result_elems x contraction for every dot,
                       trip-scaled (per device);
  * collectives      — result bytes per collective kind, trip-scaled;
  * hbm_bytes_proxy  — sum of instruction result bytes (fusion internals
                       excluded), trip-scaled, x2 for read+write — a
                       proxy for HBM traffic used in the memory term.

Everything is *per device*: the SPMD module is the per-device program.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16, "f8e4m3fn": 1,
                "f8e5m2": 1, "s4": 1, "u4": 1}

_SHAPE_RE = re.compile(
    r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred|c64|c128|"
    r"f8e4m3fn|f8e5m2|s4|u4)\[([0-9,]*)\]")

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\([^)]*\)\s*->")
_INSTR = re.compile(r"^\s+(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALL_REFS = re.compile(r"(?:body|calls|to_apply|branch_computations)="
                        r"\{?%?([\w\.\-, %]+)\}?")


@dataclass
class Instr:
    name: str
    text: str          # everything after '='
    result_bytes: int
    result_dims: Optional[Tuple[int, ...]]
    result_dtype: Optional[str]


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    is_entry: bool = False
    is_fusion: bool = False


def _first_shape(text: str):
    m = _SHAPE_RE.search(text)
    if not m:
        return None, None
    dims = tuple(int(d) for d in m.group(2).split(",")) if m.group(2) else ()
    return dims, m.group(1)


def _all_shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        n = 1
        if m.group(2):
            for d in m.group(2).split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[m.group(1)]
    return total


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if not line.startswith(" "):  # computation header or closing brace
            if line.startswith("}"):
                cur = None
                continue
            # header: [ENTRY] %name (args) -> type {   (args may nest parens)
            if ") -> " in line and line.rstrip().endswith("{"):
                head = line.strip()
                is_entry = head.startswith("ENTRY")
                if is_entry:
                    head = head[len("ENTRY"):].strip()
                name = head.split(" (", 1)[0].split("(", 1)[0]
                name = name.lstrip("%").strip()
                cur = Computation(name=name, is_entry=is_entry,
                                  is_fusion="fused_computation" in name)
                comps[name] = cur
            continue
        if cur is None:
            continue
        mi = _INSTR.match(line)
        if not mi:
            continue
        name, rest = mi.group(1), mi.group(2)
        # result type: text up to the op call "opname("
        dims, dt = _first_shape(rest)
        rb = 0
        # result bytes: first type region (up to first op paren)
        paren = rest.find("(")
        type_region = rest[:paren] if paren > 0 else rest
        rb = _all_shape_bytes(type_region)
        cur.instrs.append(Instr(name, rest, rb, dims, dt))
    return comps


def _op_of(instr: Instr) -> str:
    # op name = token immediately before the first '(' after the type
    m = re.search(r"([\w\-]+)\(", instr.text)
    return m.group(1) if m else ""


def build_multipliers(comps: Dict[str, Computation]) -> Dict[str, float]:
    """comp name -> product of enclosing trip counts (summed over call
    sites). The call graph is a DAG: relax edges to fixpoint."""
    # collect call edges: (caller, callee, factor)
    edges: List[Tuple[str, str, float]] = []
    for comp in comps.values():
        for ins in comp.instrs:
            refs = _CALL_REFS.findall(ins.text)
            if not refs:
                continue
            trip = 1.0
            tm = _TRIP.search(ins.text)
            is_while = re.search(r"\bwhile\(", ins.text) is not None
            if tm and is_while:
                trip = float(tm.group(1))
            for ref_group in refs:
                for ref in re.split(r"[,\s%]+", ref_group):
                    if ref and ref in comps:
                        edges.append((comp.name, ref, trip))

    entry = next((c for c in comps.values() if c.is_entry), None)
    if entry is None:
        entry = next(iter(comps.values()))
    # iterative accumulation (call graph is a DAG, so this converges in
    # <= depth passes; recomputed from scratch each pass)
    mult: Dict[str, float] = defaultdict(float)
    mult[entry.name] = 1.0
    for _ in range(64):
        nxt: Dict[str, float] = defaultdict(float)
        nxt[entry.name] = 1.0
        for caller, callee, factor in edges:
            nxt[callee] += mult.get(caller, 0.0) * factor
        nxt[entry.name] = 1.0
        same = (set(nxt) == set(mult)
                and all(abs(nxt[k] - mult[k]) < 1e-9 for k in nxt))
        mult = nxt
        if same:
            break
    return dict(mult)


def analyze(text: str) -> Dict[str, float]:
    comps = parse_module(text)
    mult = build_multipliers(comps)
    # map instruction name -> dims for operand lookup (per computation)
    out = {
        "dot_flops": 0.0,
        "hbm_bytes_proxy": 0.0,
        "collective_bytes": 0.0,
        "collective_count": 0.0,
        "while_count": 0.0,
    }
    per_coll = {k: 0.0 for k in _COLL_OPS}

    for comp in comps.values():
        m = mult.get(comp.name, 0.0)
        if m == 0.0:
            continue
        shapes = {i.name: (i.result_dims, i.result_dtype)
                  for i in comp.instrs}
        for ins in comp.instrs:
            op = _op_of(ins)
            if op == "dot":
                flops = _dot_flops(ins, shapes)
                out["dot_flops"] += m * flops
            elif op == "while":
                out["while_count"] += m
            for ck in _COLL_OPS:
                if op == ck or op == ck + "-start":
                    b = ins.result_bytes
                    per_coll[ck] += m * b
                    out["collective_bytes"] += m * b
                    out["collective_count"] += m
            if not comp.is_fusion and op not in ("tuple", "get-tuple-element",
                                                 "parameter", "constant",
                                                 "bitcast"):
                out["hbm_bytes_proxy"] += m * ins.result_bytes
    out["hbm_bytes_proxy"] *= 2.0  # read + write
    for k, v in per_coll.items():
        out[f"coll_{k}"] = v
    return out


def _dot_flops(ins: Instr, shapes: Dict[str, tuple]) -> float:
    if ins.result_dims is None:
        return 0.0
    n_out = 1
    for d in ins.result_dims:
        n_out *= d
    # contraction size from lhs operand shape + lhs_contracting_dims
    m = re.search(r"dot\(%?([\w\.\-]+)", ins.text)
    mc = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.text)
    contr = 1
    if m and mc and m.group(1) in shapes:
        dims, _ = shapes[m.group(1)]
        if dims is not None and mc.group(1):
            for idx in mc.group(1).split(","):
                i = int(idx)
                if i < len(dims):
                    contr *= dims[i]
    return 2.0 * n_out * contr
