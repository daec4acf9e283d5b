"""Roofline terms of one step, counted as it runs (port of
``repro.roofline.analysis``).

The reference parses XLA's partitioned HLO text (``parse_hlo``,
``analyze_hlo_text``, ``roofline_from_text``), multiplying ``while``
bodies by their trip counts. PyTorch has no such text, and those three
have no counterpart. In their place ``count_step(fn, *args)`` runs the
step once under ``StepCounter``, a ``TorchDispatchMode``, and counts the
aten ops it dispatches: the reference's ``HloStats`` fields from the ops
themselves. Eager code unrolls every loop (layers, micro-batches, kv
chunks), so no trip-count arithmetic is needed. Run on meta tensors, the
step does no arithmetic and holds no data.

Accounting model (per device):

* flops     — 2 * prod(output dims) * contracted size per matrix product
              (``mm``, ``addmm``, ``bmm``, ``baddbmm``), as the parser
              counts each ``dot``.
* hbm bytes — operand + output bytes of every op, each op a kernel
              boundary: eager PyTorch runs each op as its own kernel, so
              the boundary is every op, where XLA's is every fusion. Views
              and metadata-only ops (aliases, ``detach``, allocation
              without a write) move nothing and are skipped, as the parser
              skips plumbing.
* collective bytes — operand bytes of the ``c10d_functional`` ops that
              DTensor issues (all-gather, all-reduce, reduce-scatter,
              all-to-all, broadcast), by kind, count and dtype.
* kernel_fusable_bytes — the hbm bytes of the ops inside a
              ``kernel_scope`` (``roofline.scope``): the reference's two
              ``KERNEL_SCOPES``, flash attention's chunked scan and the SSD
              scan's intra-chunk part, which a fused kernel keeps on chip.

Per device: the mode steps aside for a DTensor op (returns
``NotImplemented``), so DTensor desugars it into ops on the local shards
and the collectives its placements need, and those are what is counted;
the fake-tensor ops DTensor runs on global shapes to propagate them are
not.

``StepCounter`` also tracks the bytes of the storages the step allocates
(``peak_bytes``; a storage is freed when its last tensor dies), the
dry run's temp memory, and at the peak the op whose output set it
(``peak_op``) and the live bytes by the op that allocated them
(``peak_live_by_op``).

Roofline terms (seconds): flops / PEAK_FLOPS_BF16, hbm_bytes / HBM_BW,
collective_bytes / COLLECTIVE_BW, per device: the H100's datasheet
figures (``roofline.hw``), not measurements.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from . import hw
from .scope import KERNEL_SCOPES, active

# the HLO dtype names the reference records collectives under
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32", torch.float64: "f64",
                torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
                torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd")

_MATMULS = ("mm", "addmm", "bmm", "baddbmm")

# ops that move no bytes of their own
_NO_BYTES = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
             "new_empty", "new_empty_strided", "empty_like",
             "_local_scalar_dense", "wait_tensor", "set_", "resize_",
             "_to_copy_meta", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size", "_has_compatible_shallow_"
             "copy_type", "copy_meta"}


@dataclasses.dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    kernel_fusable_bytes: float = 0.0     # interior bytes of kernel scopes
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    # eager code has no while loops: the reference's field stays empty
    while_trip_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    hbm_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add_collective(self, kind: str, nbytes: float, count: float,
                       dtype: str = "?"):
        self.collective_bytes += nbytes
        self.collective_by_kind[kind] = (self.collective_by_kind.get(kind, 0.0)
                                         + nbytes)
        self.collective_count[kind] = (self.collective_count.get(kind, 0)
                                       + int(count))
        self.collective_by_dtype[dtype] = (
            self.collective_by_dtype.get(dtype, 0.0) + nbytes)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _matmul_flops(name: str, args, out) -> float:
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    n = 1
    for d in out.shape:
        n *= d
    return 2.0 * n * a.shape[-1]


class StepCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active into ``stats``
    (an ``HloStats``), and the bytes of the storages allocated meanwhile:
    ``live_bytes`` now, ``peak_bytes`` the most at once. Storages of
    tensors passed to ``exclude`` (the step's arguments) are not counted
    as allocations. At the peak it keeps the op that set it
    (``peak_op``) and the bytes then live by allocating op
    (``peak_live_by_op``)."""

    def __init__(self, exclude=()):
        super().__init__()
        self.stats = HloStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_op = None
        self.peak_live_by_op: Dict[str, int] = {}
        self._live_by_op: Dict[str, int] = {}
        self._known = set()
        for t in _tensors(exclude):
            self._known.add(self._key(t))

    @staticmethod
    def _key(t):
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        return t.untyped_storage()._cdata

    def _track(self, out, op: str) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            self._known.add(key)
            nbytes = st.nbytes()
            self.live_bytes += nbytes
            self._live_by_op[op] = self._live_by_op.get(op, 0) + nbytes
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self.peak_op = op
                self.peak_live_by_op = dict(self._live_by_op)
            weakref.finalize(st, self._free, key, nbytes, op)

    def _free(self, key, nbytes, op) -> None:
        self._known.discard(key)
        self.live_bytes -= nbytes
        self._live_by_op[op] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # count the ops it desugars into
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            return out    # DTensor's shape propagation, on global shapes
        name = func._opname
        s = self.stats
        if func.namespace in _COLLECTIVE_NAMESPACES or (
                func.namespace == "c10d" and name in _COLLECTIVES):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                ins = list(_tensors(args[0]))
                dt = _DTYPE_NAMES.get(ins[0].dtype, "?") if ins else "?"
                nbytes = _nbytes(args[0])
                s.add_collective(kind, nbytes, 1, dtype=dt)
                s.hbm_bytes += nbytes + _nbytes(out)
            self._track(out, name)
            return out
        if func.namespace == "aten" and name in _MATMULS:
            s.flops += _matmul_flops(name, args, out)
        if not (func.is_view or name in _NO_BYTES
                or func.namespace not in ("aten", "prims")):
            nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            s.hbm_bytes += nbytes
            s.hbm_by_opcode[name] = s.hbm_by_opcode.get(name, 0.0) + nbytes
            if active() in KERNEL_SCOPES:
                s.kernel_fusable_bytes += nbytes
        self._track(out, name)
        return out


def count_step(fn, *args, **kwargs) -> HloStats:
    """The ``HloStats`` of one call of ``fn(*args, **kwargs)``."""
    with StepCounter() as counter:
        fn(*args, **kwargs)
    return counter.stats


# ---------------------------------------------------------------- roofline
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    collective_count: Dict[str, int]
    kernel_fusable_bytes: float = 0.0
    collective_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def memory_s_fused(self) -> float:
        """Memory term with the kernel scopes' interiors kept on chip (the
        hand-written kernels' configuration; see ``KERNEL_SCOPES``)."""
        return max(self.hbm_bytes - self.kernel_fusable_bytes, 0.0) / hw.HBM_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_fused": self.memory_s_fused,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "kernel_fusable_bytes_per_device": self.kernel_fusable_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_by_kind": self.collective_by_kind,
            "collective_count": self.collective_count,
            "collective_by_dtype": self.collective_by_dtype,
        }


def roofline_from_stats(s: HloStats) -> Roofline:
    """The three terms of a counted step on the H100's figures."""
    return Roofline(
        compute_s=s.flops / hw.PEAK_FLOPS_BF16,
        memory_s=s.hbm_bytes / hw.HBM_BW,
        collective_s=s.collective_bytes / hw.COLLECTIVE_BW,
        flops=s.flops, hbm_bytes=s.hbm_bytes,
        collective_bytes=s.collective_bytes,
        collective_by_kind=s.collective_by_kind,
        collective_count=s.collective_count,
        kernel_fusable_bytes=s.kernel_fusable_bytes,
        collective_by_dtype=s.collective_by_dtype,
    )


# ------------------------------------------------------- model flops (6ND)
def model_flops(cfg, n_tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference forward
    (N = active params excluding embeddings/vocab head for MoE accounting)."""
    n_active = active_param_count(cfg)
    per_tok = 6.0 * n_active if kind == "train" else 2.0 * n_active
    return per_tok * n_tokens


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count, analytic."""
    d = cfg.d_model
    n = 0.0
    # embeddings participate as lookup, count vocab head as matmul params
    n += cfg.vocab * d  # lm head (tied or not, the matmul happens)
    for seg in _plan(cfg):
        for kind in seg.pattern:
            n += seg.n_repeat * _block_active_params(cfg, kind)
    return n


def _plan(cfg):
    from repro_torch.models.common import layer_plan
    return layer_plan(cfg)


def _block_active_params(cfg, kind: str) -> float:
    d = cfg.d_model
    if kind == "mamba":
        din, ng, st, nh = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                           cfg.ssm_nheads)
        return d * (2 * din + 2 * ng * st + nh) + din * d
    n = 0.0
    if cfg.use_mla and kind in ("dense", "moe"):
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        n += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.nq * qk
        n += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        n += cfg.kv_lora_rank * cfg.nq * (cfg.qk_nope_head_dim
                                          + cfg.v_head_dim)
        n += cfg.nq * cfg.v_head_dim * d
    else:
        hd = cfg.hd
        n += d * hd * (cfg.nq + 2 * cfg.nkv) + cfg.nq * hd * d
    if kind == "moe":
        ff = cfg.expert_d_ff
        n += cfg.top_k * 3 * d * ff                                  # routed
        n += cfg.n_shared_experts * 3 * d * (cfg.shared_d_ff or ff)  # shared
        n += d * cfg.n_experts                                       # router
    else:
        mult = 3 if cfg.gated_mlp else 2
        ff = cfg.d_ff if not (cfg.n_experts and cfg.first_k_dense
                              and kind == "dense") \
            else (cfg.d_ff or cfg.shared_d_ff)
        n += mult * d * ff
    return n
