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
  on the card (each trial :data:`FLASH_MEASURE_REPS` launches back to
  back, the cost per launch) and the winner persists under a (family,
  shape class, backend descriptor) key.

``ops.cuda_kernels.flash_attention`` loads winners at call time under
``MXNET_KERNEL_SEARCH=1``.  ``search_fc`` and ``search_paged`` wait: the
port's fc and paged kernels have no tile parameter yet (ROADMAP.md, queue
1 item 11).  The shape-class tuples equal the JAX package's.
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

__all__ = ["search_flash", "best_config", "flash_class", "fc_class",
           "paged_class", "parity_fail_total", "flash_candidates",
           "FLASH_GATE_ATOL", "FLASH_MEASURE_REPS"]

Config = Dict[str, Any]

FLASH_GATE_ATOL = 2e-5
# launches per timed trial: the host clock around one launch and its
# synchronization carries tens of microseconds of jitter, as much as the
# difference between two tiles at the search's shape; the cost is per call
FLASH_MEASURE_REPS = 8

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
            for _ in range(FLASH_MEASURE_REPS):
                ck.flash_attention(q, k, v, causal=causal,
                                   block_q=cfg["block_q"],
                                   block_k=cfg["block_k"])
        return measure_candidate(
            run, label="flash:%(block_q)dx%(block_k)d" % cfg, trials=trials,
            warmup=1) / FLASH_MEASURE_REPS

    try:
        best, _cost = tuner.tune(cands, featurize, measure,
                                 meta={"class": list(cls)}, gate=gate)
    finally:
        # count gate failures even when every candidate failed and the
        # search raised
        _note_parity_fail(tuner.gate_failures)
    _forget(key)
    return best
