"""Static-graph Program IR of the port: Program / Block / Operator /
Variable (counterpart of paddle_tpu/fluid/framework.py).

The Python object tree IS the program, and `Program.to_dict` /
`from_dict` JSON is interchangeable both ways with the reference's: a
program built by either package loads in the other.  An op is a rule of
the port's registry (paddle_tpu_torch/ops/registry.py) that emits torch
operations; the Executor runs a block's rules in order as one torch
callable.  Build-time shape inference runs the op's own rule on `meta`
tensors, with -1 (batch) dims found by probing two sizes, as the
reference does with `jax.eval_shape`.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import core, unique_name
from .flags import flag

GRAD_SUFFIX = "@GRAD"
EMPTY_VAR_NAME = "@EMPTY@"

# package root, for filtering framework frames out of recorded op
# construction stacks (FLAGS_op_callstack)
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_callstack(limit: int = 3) -> List[str]:
    """Nearest non-framework construction frames, innermost last —
    attached to ops as attrs['op_callstack'] when FLAGS_op_callstack is
    set, and surfaced by analysis.verifier findings."""
    out: List[str] = []
    for fr in reversed(traceback.extract_stack()[:-3]):
        if os.path.abspath(fr.filename).startswith(_PKG_DIR):
            continue
        out.append(f"{fr.filename}:{fr.lineno} ({fr.name})")
        if len(out) >= limit:
            break
    return list(reversed(out))


class Variable:
    """A named tensor in a Block.

    Holds only metadata: shape (-1 for batch-like dims), dtype name,
    persistable / stop_gradient flags.  Runtime values are torch tensors
    living in a Scope (executor.py)."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        type: str = core.VarType.LOD_TENSOR,
        is_data: bool = False,
        **kwargs,
    ):
        self.block = block
        self.name = name if name is not None else unique_name.generate("_generated_var")
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = core.convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.lod_level = kwargs.get("lod_level", 0)
        self.is_parameter = False

    # -- paddle-compatible sugar -------------------------------------------
    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype},"
            f" persistable={self.persistable}, stop_gradient={self.stop_gradient})"
        )

    __str__ = __repr__

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_data": self.is_data,
            "is_parameter": self.is_parameter,
        }

    # Arithmetic sugar is installed by fluid.layers.math_op_patch at
    # import time.


class Parameter(Variable):
    """A trainable persistable Variable (framework.py:5155)."""

    def __init__(self, block, name, shape, dtype, trainable=True, optimize_attr=None,
                 regularizer=None, do_model_average=False, need_clip=True, **kwargs):
        super().__init__(
            block, name=name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=not trainable, **kwargs,
        )
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.do_model_average = do_model_average
        self.need_clip = need_clip
        self.is_parameter = True

    def to_dict(self):
        d = super().to_dict()
        d["trainable"] = self.trainable
        return d


class Operator:
    """One node in a Block: type + name-maps of inputs/outputs + attrs
    (OpDesc, framework.proto:42; framework.py:1923).

    `inputs` / `outputs` map slot names (e.g. "X", "Out") to lists of
    variable names.  `attrs` must be JSON-serializable; sub-blocks are
    referenced by index via the "sub_block" attr."""

    def __init__(self, block, op_id, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.id = op_id
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_name_map(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_name_map(outputs)
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items() if v}
        outs = {k: v for k, v in self.outputs.items() if v}
        return f"{outs} = {self.type}({ins}) attrs={self.attrs}"

    def to_dict(self):
        return {
            "id": self.id,
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonify_attrs(self.attrs),
        }


def _normalize_name_map(m) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    if not m:
        return out
    for slot, vals in m.items():
        if vals is None:
            out[slot] = []
            continue
        if isinstance(vals, (Variable, str)):
            vals = [vals]
        out[slot] = [v.name if isinstance(v, Variable) else str(v) for v in vals]
    return out


def _jsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


class Block:
    """An ordered list of Operators plus a name->Variable symbol table
    (framework.proto:174; framework.py:2520)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []
        self.forward_block_idx = -1

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- variables ---------------------------------------------------------
    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block {self.idx}")
        return v

    def _var_recursive(self, name: str) -> Variable:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError(f"variable {name!r} not found in block {self.idx} or ancestors")

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def has_var_recursive(self, name: str) -> bool:
        try:
            self._var_recursive(name)
            return True
        except ValueError:
            return False

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        name = kwargs.pop("name")
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        p = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[p.name] = p
        self.program._bump_version()
        return p

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- operators ---------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        return self.insert_op(len(self.ops), type, inputs, outputs, attrs,
                              infer_shape)

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None, infer_shape: bool = True) -> Operator:
        """Insert an op at `index` (used by program-rewrite passes, e.g.
        the quantization transform)."""
        op = Operator(self, self.program._next_op_id(), type, inputs,
                      outputs, attrs)
        if flag("op_callstack") and "op_callstack" not in op.attrs:
            op.attrs["op_callstack"] = _user_callstack()
        self.ops.insert(index, op)
        self.program._bump_version()
        if infer_shape:
            self._infer_shapes(op)
        return op

    def _prepend_op(self, type: str, inputs=None, outputs=None, attrs=None,
                    infer_shape: bool = True) -> Operator:
        return self.insert_op(0, type, inputs, outputs, attrs, infer_shape)

    def _infer_shapes(self, op: Operator) -> None:
        """Derive output var shapes/dtypes by running the op's rule on
        meta tensors (ops/registry.infer_op_outputs: two probes, dims that
        track the -1 placeholder stay -1).  An op with no rule keeps the
        shapes its caller set; one whose rule cannot run on meta tensors
        bails out, keeps its declared shapes, and books the
        `shape_infer_bailouts` counter."""
        from ..ops import registry

        try:
            inferred = registry.infer_op_outputs(op, self)
        except registry.ShapeInferSkip:
            return
        except registry.ShapeInferBail as bail:
            from ..profiler import stat_add

            stat_add("shape_infer_bailouts")
            registry.log_bailout_once(bail.op_type, bail.reason)
            return
        for name, (shape, dtype) in inferred.items():
            v = self.vars.get(name)
            if v is None:
                v = self._var_recursive(name)
            v.shape = shape
            v.dtype = core.convert_dtype(dtype)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A list of Blocks; block 0 is the global block.  Programs are cheap
    pure-Python objects; the Executor builds one callable per (program id
    and version, feed signature, fetch list) and caches it."""

    # sequential program identity for greppable verifier provenance
    # ("program#<id> block<idx> op<idx> (<type>)", analysis/verifier.py)
    _prog_id_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._op_id_counter = 0
        self._seed_counter = 0
        self._is_test = False
        self.prog_id = next(Program._prog_id_counter)
        # clone lineage: clones share the root program's id so analyses
        # (cross-program collective-order, finding dedup) can group a
        # train step with its eval clone
        self.clone_root = self.prog_id

    # -- identity / caching ------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    def _bump_version(self):
        self._version += 1

    def _next_op_id(self) -> int:
        i = self._op_id_counter
        self._op_id_counter += 1
        return i

    # -- block management --------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    # -- introspection -----------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [p for blk in self.blocks for p in blk.all_parameters()]

    def num_ops(self) -> int:
        return sum(len(b.ops) for b in self.blocks)

    # -- cloning -----------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program.  With for_test=True, flips `is_test` attrs
        (batch_norm/dropout eval behavior) and prunes backward/optimize ops,
        mirroring Program.clone(for_test=True) (framework.py:4312)."""
        p = Program()
        p.clone_root = self.clone_root
        p.random_seed = self.random_seed
        p._op_id_counter = self._op_id_counter
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            nb.forward_block_idx = blk.forward_block_idx
            for v in blk.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[nv.name] = nv
            for op in blk.ops:
                # prune backward/optimize ops by role mask (roles may be
                # OR-combined, e.g. Backward|Loss = 257)
                if for_test and (op.attr("op_role", 0)
                                 & (OpRole.Backward | OpRole.Optimize)):
                    continue
                nop = Operator(nb, op.id, op.type,
                               {k: list(v) for k, v in op.inputs.items()},
                               {k: list(v) for k, v in op.outputs.items()},
                               copy.deepcopy(op.attrs))
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p._is_test = for_test
        p._bump_version()
        return p

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        from .op_version_registry import version_map

        # only the ops this program uses
        used = {op.type for b in self.blocks for op in b.ops}
        return {
            "format": "paddle_tpu.program.v1",
            "random_seed": self.random_seed,
            "op_id_counter": self._op_id_counter,
            "op_version_map": version_map(used),
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d: dict) -> "Program":
        assert d.get("format") == "paddle_tpu.program.v1", "unknown program format"
        from .op_version_registry import check_compatibility

        check_compatibility(d.get("op_version_map", {}))
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p._op_id_counter = d.get("op_id_counter", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            blk.forward_block_idx = bd.get("forward_block_idx", -1)
            for vd in bd["vars"]:
                cls = Parameter if vd.get("is_parameter") else Variable
                if cls is Parameter:
                    v = Parameter(blk, vd["name"], vd["shape"], vd["dtype"],
                                  trainable=vd.get("trainable", True))
                else:
                    v = Variable(blk, name=vd["name"], shape=vd["shape"],
                                 dtype=vd["dtype"],
                                 persistable=vd.get("persistable", False),
                                 stop_gradient=vd.get("stop_gradient", False),
                                 type=vd.get("type", core.VarType.LOD_TENSOR),
                                 is_data=vd.get("is_data", False))
                blk.vars[v.name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, val in od["attrs"].items():
                    if isinstance(val, dict) and "__ndarray__" in val:
                        attrs[k] = np.array(val["__ndarray__"], dtype=val["dtype"])
                    else:
                        attrs[k] = val
                blk.ops.append(Operator(blk, od["id"], od["type"], od["inputs"],
                                        od["outputs"], attrs))
            p.blocks.append(blk)
        p._bump_version()
        return p

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Program":
        import json

        return Program.from_dict(json.loads(s))

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
            for op in blk.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Default program registry + guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


_DYGRAPH = [False]  # switched by fluid.dygraph.guard / enable_dygraph


def in_dygraph_mode() -> bool:
    """True inside `fluid.dygraph.guard()` (or after `enable_dygraph`):
    the eager mode, whose tape is torch autograd."""
    return _DYGRAPH[0]


# op_role constants: tag forward (0) / backward (1) / optimize (2) ops for
# clone(for_test) pruning.
class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def block_io(blk: "Block"):
    """(names read before written, names written) of a block's own ops,
    each in first-seen order: what an op running the block as its
    sub-block lists as its inputs and outputs."""
    defined = set()
    reads, writes = [], []
    seen_r, seen_w = set(), set()
    for op in blk.ops:
        for n in op.input_arg_names():
            if n not in defined and n not in seen_r:
                seen_r.add(n)
                reads.append(n)
        for n in op.output_arg_names():
            if n not in seen_w:
                seen_w.add(n)
                writes.append(n)
            defined.add(n)
    return reads, writes


@contextlib.contextmanager
def name_scope(prefix=None):
    """Name-scope prefix for debugging/visualization.  Op naming is flat,
    so the scope is a no-op context kept for API parity."""
    yield
