"""Kernel search: tile candidates, parity-gated, cost-model-ranked,
persisted per device (counterpart of ``mxnet_tpu/autotune/kernelsearch.py``).

The flash-attention kernel (``csrc/flash_attention.cu``) is compiled for a
fixed set of (block_q, block_k) tiles, :data:`~mxnet_tpu_torch.ops.
cuda_kernels.FLASH_TILES`; :func:`search_flash` searches among them for one
shape class:

* **candidates**: every compiled tile, each dimension cut to the smallest
  compiled size that covers T, duplicates dropped (a tile wider than the
  sequence holds the same single tile of work);
* **gate**: each candidate's kernel output on a seeded probe must lie
  within atol 2e-5 of ``flash_attention_reference`` before it may be
  ranked; a failure is logged (``"parity": False``), counted in
  :func:`parity_fail_total` and can never win.  The JAX gate also asks for
  bitwise equality with a jnp replay of the kernel's blockwise op
  sequence; that part has no counterpart here, because a PyTorch replay
  cannot reproduce the float order of the kernel's tensor-core (3xTF32)
  and shuffle sums;
* **ranking**: the shared cost model over the JAX package's features (a
  smaller q tile re-reads K and V more often); the shortlist is measured
  on the card's clock with the inputs cold (:func:`launch_cost`, as the
  kernels' own rows are timed) and the winner persists under a (family,
  shape class, backend descriptor) key.

The same machinery searches the two other tunable kernels:

* :func:`search_fc` -- ``fused_fc_epilogue``'s column tile ``block_n``
  (:data:`~mxnet_tpu_torch.ops.cuda_kernels.FC_TILES`, compiled for
  float32 operands; other dtypes have the default tile only).  Its gate
  asks for outputs bitwise equal to the default tile's, and int8 codes
  exactly equal to the plain version's: every tile sums an output over K
  in the same order, so no tolerance is needed;
* :func:`search_paged` -- ``paged_attention``'s split-K partition length
  (:data:`~mxnet_tpu_torch.ops.cuda_kernels.PAGED_PART_KEYS`, 0 for one
  pass).  The JAX search chooses between its page-walk kernel and a
  dense gather; a "dense" winner would run the plain version on the card,
  which the port never does, so the port searches the kernel's own free
  parameter instead.  Its gate is atol 3e-5 against
  ``paged_attention_reference``, the reference search's tolerance.  A
  winner is stored for :func:`paged_cap_class`: the shape class and the
  page table's capacity, which the partition count follows.

``ops.cuda_kernels`` loads every winner at call time under
``MXNET_KERNEL_SEARCH=1``; a stored winner that names an instance that is
not compiled counts as no winner.  The shape-class tuples equal the JAX
package's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import make_lock
from ..context import Context, gpu
from .costmodel import COSTMODEL_VERSION, clean_config, features
from .joint import JointTuner
from .measure import measure_candidate, tuning_key
from .store import load_config

__all__ = ["search_flash", "search_fc", "search_paged", "best_config",
           "flash_class", "fc_class", "paged_class", "paged_cap_class",
           "launch_cost", "parity_fail_total",
           "flash_candidates", "fc_candidates", "paged_candidates",
           "FLASH_GATE_ATOL", "PAGED_GATE_ATOL", "FLASH_MEASURE_REPS"]

Config = Dict[str, Any]

FLASH_GATE_ATOL = 2e-5
# the reference search's paged tolerance (mxnet_tpu/autotune/kernelsearch.py)
PAGED_GATE_ATOL = 3e-5
# launches timed per trial; the cost is per launch
FLASH_MEASURE_REPS = 8
# cycles the stream spins before a timed launch (0.2 ms on an H100),
# longer than a wrapper's host work
_LEAD_CYCLES = 400_000
# bytes read before a timed launch to leave the L2 (50 MB) cold
_FLUSH_BYTES = 256 * 2 ** 20

_parity_fail = 0
_pf_lock = make_lock("autotune.kernelsearch")


def parity_fail_total() -> int:
    """Parity-gate failures across every search this process ran."""
    return _parity_fail


def _note_parity_fail(n: int) -> None:
    global _parity_fail
    with _pf_lock:
        _parity_fail += n


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dtype_name(dtype) -> str:
    """numpy's name for a numpy or torch dtype (``torch.float32`` ->
    ``"float32"``), as the JAX package's classes spell it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return str(np.dtype(dtype))


# -- shape classes (what a winner generalizes over) --------------------------

def flash_class(t: int, d: int, causal: bool, dtype) -> Tuple:
    """Sequence length buckets to its pow2 ceiling: the winning tiles for
    T=200 and T=256 are the same search problem."""
    return ("flash", _dtype_name(dtype), _pow2_ceil(t), int(d), bool(causal))


def fc_class(n: int, k: int, act_type: str, int8: bool, dtype) -> Tuple:
    return ("fc_epilogue", _dtype_name(dtype), int(n), int(k),
            str(act_type), bool(int8))


def paged_class(bt: int, d: int, causal: bool, dtype) -> Tuple:
    return ("paged", _dtype_name(dtype), int(bt), int(d), bool(causal))


def paged_cap_class(bt: int, d: int, causal: bool, dtype, cap: int) -> Tuple:
    """The class a partition length is searched and stored for:
    :func:`paged_class` and the page table's capacity ``cap = B * bt``
    keys, to its pow2 ceiling.  The partitions a length gives follow the
    capacity, so a winner holds for the capacity it was measured at.  A
    capacity is a shape, not a length: every layout of one cache, and one
    engine's decode and verify calls, share the class."""
    return paged_class(bt, d, causal, dtype) + (_pow2_ceil(cap),)


# -- winner lookup (the call-time path) --------------------------------------

_best_cache: Dict[str, Optional[Config]] = {}
_cache_lock = make_lock("autotune.kernelsearch")


def _class_key(cls: Sequence, device=None) -> str:
    return tuning_key("kernelsearch:%s" % cls[0], tuple(cls), device=device)


def best_config(cls: Sequence, device=None) -> Optional[Config]:
    """The persisted winner for a shape class on ``device``'s backend, or
    None.  Load-only (no search, no measurement) and process-cached,
    negative results included."""
    key = _class_key(cls, device)
    with _cache_lock:
        if key in _best_cache:
            return _best_cache[key]
    doc = load_config(key, model_version=COSTMODEL_VERSION)
    cfg = clean_config(doc["config"]) if doc else None
    with _cache_lock:
        _best_cache[key] = cfg
    return cfg


def _forget(key: str) -> None:
    with _cache_lock:
        _best_cache.pop(key, None)


def launch_cost(launch, label: str, trials: int, device) -> float:
    """Seconds one ``launch()`` of a candidate takes.  On the card the
    clock is the device's, as in the trace spans the JAX package's
    searches read, and the inputs arrive cold, as a model's weights and
    KV cache do: before each launch a read of a 256 MB buffer leaves the
    50 MB L2 holding unrelated lines and a spin keeps the card busy while
    the host queues the launch between two CUDA events, so neither a
    warm L2 nor the wrapper's host work enters the time.  The median of
    ``trials`` x :data:`FLASH_MEASURE_REPS` launches, after one off the
    clock (the build, the first launch).  On the host,
    :func:`measure_candidate`'s wall."""
    if device.type != "cuda":
        def reps():
            for _ in range(FLASH_MEASURE_REPS):
                launch()
        return measure_candidate(reps, label=label, trials=trials,
                                 warmup=1) / FLASH_MEASURE_REPS
    with torch.cuda.device(device):
        flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=device)
        launch()
        n = max(1, trials) * FLASH_MEASURE_REPS
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for start, end in zip(starts, ends):
            flush.sum()
            torch.cuda._sleep(_LEAD_CYCLES)
            start.record()
            launch()
            end.record()
        ends[-1].synchronize()
        ms = sorted(s_.elapsed_time(e) for s_, e in zip(starts, ends))
        del flush
    return ms[n // 2] / 1e3


# -- the flash search --------------------------------------------------------

def flash_candidates(t: int) -> List[Config]:
    """The compiled tiles cut to T, duplicates dropped, in tile order."""
    from ..ops import cuda_kernels as ck
    seen, cands = set(), []
    for bq, bk in ck.FLASH_TILES:
        eff = (ck.clamp_tile(bq, t, ck.FLASH_BLOCK_Q),
               ck.clamp_tile(bk, t, ck.FLASH_BLOCK_K))
        if eff in seen:
            continue
        seen.add(eff)
        cands.append({"block_q": int(eff[0]), "block_k": int(eff[1])})
    return cands


def search_flash(b: int, t: int, h: int, d: int, causal: bool = False,
                 dtype=np.float32, trials: int = 2, persist: bool = True,
                 shortlist: Optional[int] = None,
                 ctx: Optional[Context] = None) -> Config:
    """Search (block_q, block_k) for one flash shape class on ``ctx``
    (default ``gpu(0)``); returns the winning ``{"block_q", "block_k"}``,
    persisted, so later searches and call-time resolution load it with
    zero measurements."""
    from ..ops import cuda_kernels as ck
    device = (ctx if ctx is not None else gpu(0)).torch_device()
    cls = flash_class(t, d, causal, dtype)
    cands = flash_candidates(t)
    itemsize = int(np.dtype(_dtype_name(dtype)).itemsize)
    key = _class_key(cls, device)
    tuner = JointTuner("kernelsearch:flash", key, persist=persist,
                       shortlist=shortlist, device=device)
    probe: List[torch.Tensor] = []
    ref: List[torch.Tensor] = []

    def inputs():
        # made on first use, so a store hit allocates nothing
        if not probe:
            rng = np.random.RandomState(0)
            probe.extend(torch.from_numpy(rng.randn(b, t, h, d).astype(
                _dtype_name(dtype))).to(device) for _ in range(3))
            ref.append(ck.flash_attention_reference(*probe, causal=causal))
        return probe

    def gate(cfg: Config) -> bool:
        got = ck.flash_attention(*inputs(), causal=causal,
                                 block_q=cfg["block_q"],
                                 block_k=cfg["block_k"])
        err = (got.float() - ref[0].float()).abs().max().item() \
            if got.numel() else 0.0
        return got.shape == ref[0].shape and err <= FLASH_GATE_ATOL

    kv_bytes = 2 * t * d * itemsize                 # one head's K+V

    def featurize(cfg: Config) -> List[float]:
        n_q_blocks = -(-_round_up(t, cfg["block_q"]) // cfg["block_q"])
        traffic = b * h * (2 * t * d * itemsize     # Q read + O write
                           + kv_bytes * n_q_blocks)  # K/V per q-block
        return features(gflops=4.0 * b * h * t * t * d / 1e9,
                        hbm_gb=traffic / 1e9,
                        block_q=cfg["block_q"], block_k=cfg["block_k"])

    def measure(cfg: Config) -> float:
        q, k, v = inputs()

        def run():
            ck.flash_attention(q, k, v, causal=causal,
                               block_q=cfg["block_q"], block_k=cfg["block_k"])
        return launch_cost(run, "flash:%(block_q)dx%(block_k)d" % cfg,
                           trials, device)

    try:
        best, _cost = tuner.tune(cands, featurize, measure,
                                 meta={"class": list(cls)}, gate=gate)
    finally:
        # count gate failures even when every candidate failed and the
        # search raised
        _note_parity_fail(tuner.gate_failures)
    _forget(key)
    return best


# -- the fc search -----------------------------------------------------------

def fc_candidates(dtype=np.float32) -> List[Config]:
    """The compiled column tiles for float32 (or ``dtype``) operands."""
    from ..ops import cuda_kernels as ck
    td = getattr(torch, _dtype_name(dtype))
    return [{"block_n": int(bn)} for bn in ck.fc_tiles_for(td, td)]


def search_fc(m: int, k: int, n: int, act_type: str = "relu",
              out_scale: Optional[float] = None, dtype=np.float32,
              trials: int = 2, persist: bool = True,
              shortlist: Optional[int] = None,
              ctx: Optional[Context] = None) -> Config:
    """Search ``block_n`` for one ``fused_fc_epilogue`` shape class on
    ``ctx`` (default ``gpu(0)``); returns the winning ``{"block_n"}``,
    persisted.  The gate: every candidate's output bitwise equal to the
    default tile's, and with ``out_scale`` the int8 codes equal to the
    plain version's."""
    from ..ops import cuda_kernels as ck
    device = (ctx if ctx is not None else gpu(0)).torch_device()
    cls = fc_class(n, k, act_type, out_scale is not None, dtype)
    cands = fc_candidates(dtype)
    itemsize = int(np.dtype(_dtype_name(dtype)).itemsize)
    key = _class_key(cls, device)
    tuner = JointTuner("kernelsearch:fc", key, persist=persist,
                       shortlist=shortlist, device=device)
    probe: List[torch.Tensor] = []
    ref: List[torch.Tensor] = []

    def inputs():
        if not probe:
            rng = np.random.RandomState(0)
            td = _dtype_name(dtype)
            probe.extend([
                torch.from_numpy(rng.randn(m, k).astype(td)).to(device),
                torch.from_numpy(rng.randn(n, k).astype(td)).to(device),
                torch.from_numpy(rng.randn(n).astype(np.float32)).to(device)])
            x, w, b = probe
            ref.append(ck.fused_fc_epilogue(x, w, b, act_type, out_scale,
                                            block_n=ck.FC_DEFAULT_TILE))
            if out_scale is not None:
                ref.append(ck.fused_fc_epilogue_reference(
                    x, w, b, act_type, out_scale))
        return probe

    def gate(cfg: Config) -> bool:
        x, w, b = inputs()
        got = ck.fused_fc_epilogue(x, w, b, act_type, out_scale,
                                   block_n=cfg["block_n"])
        same = got.shape == ref[0].shape and torch.equal(got, ref[0])
        if out_scale is not None:
            same = same and torch.equal(got, ref[1])
        return bool(same)

    def featurize(cfg: Config) -> List[float]:
        x_bytes = m * k * itemsize
        traffic = x_bytes * (-(-n // cfg["block_n"])) \
            + n * k * itemsize + m * n * 4
        return features(gflops=2.0 * m * n * k / 1e9,
                        hbm_gb=traffic / 1e9, block_n=cfg["block_n"])

    def measure(cfg: Config) -> float:
        x, w, b = inputs()

        def run():
            ck.fused_fc_epilogue(x, w, b, act_type, out_scale,
                                 block_n=cfg["block_n"])
        return launch_cost(run, "fc:n%(block_n)d" % cfg, trials, device)

    try:
        best, _cost = tuner.tune(cands, featurize, measure,
                                 meta={"class": list(cls)}, gate=gate)
    finally:
        _note_parity_fail(tuner.gate_failures)
    _forget(key)
    return best


# -- the paged search --------------------------------------------------------

def paged_candidates() -> List[Config]:
    """The partition lengths, then one pass (``part_keys`` 0)."""
    from ..ops import cuda_kernels as ck
    return [{"part_keys": int(p)} for p in ck.PAGED_PART_KEYS]


def search_paged(s: int, c: int, h: int, d: int, n_blocks: int = 8,
                 bt: int = 16, causal: bool = True, dtype=np.float32,
                 trials: int = 2, persist: bool = True,
                 shortlist: Optional[int] = None,
                 ctx: Optional[Context] = None) -> Config:
    """Search the split-K partition length for one ``paged_attention``
    class on ``ctx`` (default ``gpu(0)``); returns the winning
    ``{"part_keys"}`` (0: one pass), persisted for the page tables'
    capacity (:func:`paged_cap_class`).  The probe is the reference
    search's, ``s`` slots of ``c`` query rows over a pool of ``n_blocks``
    pages of ``bt`` keys with random page tables, but for its lengths:
    the reference draws them at random; the port spreads them evenly
    over the capacity, a slot at the capacity included, and times every
    candidate with the slots in both orders, the longest first and last.
    One pass's time follows the longest slot and where it falls in the
    grid, and an engine's slots come in any order, so a candidate costs
    the worse of the two."""
    from ..ops import cuda_kernels as ck
    device = (ctx if ctx is not None else gpu(0)).torch_device()
    nb = max(1, (n_blocks - 1) // max(1, s))
    cls = paged_cap_class(bt, d, causal, dtype, nb * bt)
    cands = paged_candidates()
    itemsize = int(np.dtype(_dtype_name(dtype)).itemsize)
    key = _class_key(cls, device)
    tuner = JointTuner("kernelsearch:paged", key, persist=persist,
                       shortlist=shortlist, device=device)
    # per slot order: (the kernel's arguments, the plain version's output)
    probes: List[Tuple[List[torch.Tensor], torch.Tensor]] = []

    def inputs():
        if not probes:
            rng = np.random.RandomState(0)
            td = _dtype_name(dtype)
            k_pool = rng.randn(n_blocks, bt, h, d).astype(td)
            v_pool = rng.randn(n_blocks, bt, h, d).astype(td)
            q = rng.randn(s, c, h, d).astype(td)
            pages = rng.permutation(n_blocks - 1)[:s * nb].reshape(
                s, nb).astype(np.int32)
            spread = np.linspace(nb * bt, c, s).round().astype(np.int32)
            for lengths in (spread, spread[::-1]):
                q_pos = lengths[:, None] - c \
                    + np.arange(c, dtype=np.int32)[None]
                args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (q, k_pool, v_pool, pages, lengths,
                                  q_pos.astype(np.int32))]
                probes.append((args, ck.paged_attention_reference(
                    *args, causal=causal)))
        return probes

    def gate(cfg: Config) -> bool:
        for args, want in inputs():
            got = ck.paged_attention(*args, causal=causal,
                                     part_keys=cfg["part_keys"])
            err = (got.float() - want.float()).abs().max().item() \
                if got.numel() else 0.0
            if got.shape != want.shape or not err <= PAGED_GATE_ATOL:
                return False
        return True

    ctx_bytes = s * nb * bt * h * d * itemsize
    qo = 2 * s * c * h * d * itemsize

    def featurize(cfg: Config) -> List[float]:
        n_part = ck.paged_partitions(c, nb * bt, cfg["part_keys"])
        # the partials' write and the merge's read
        scratch = 0 if n_part == 1 else 2 * s * c * h * n_part * (d + 2) * 4
        return features(gflops=4.0 * s * c * h * d * nb * bt / 1e9,
                        hbm_gb=(qo + 2 * ctx_bytes + scratch) / 1e9)

    def measure(cfg: Config) -> float:
        return max(launch_cost(
            lambda args=args: ck.paged_attention(
                *args, causal=causal, part_keys=cfg["part_keys"]),
            "paged:%(part_keys)d" % cfg, trials, device)
            for args, _want in inputs())

    try:
        best, _cost = tuner.tune(cands, featurize, measure,
                                 meta={"class": list(cls)}, gate=gate)
    finally:
        _note_parity_fail(tuner.gate_failures)
    _forget(key)
    return best
