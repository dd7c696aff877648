"""The token pick: per row of logits the argmax, or a Gumbel-max draw at a
temperature keyed by (rid, token index). One hand-written CUDA kernel
(``csrc/pick_tokens.cu``) and its plain PyTorch version.

Counterpart of the JAX engine's picks (``jnp.argmax`` and
``jax.random.categorical`` in ``bobrapet_tpu/serving/engine.py`` and
``serving/spec_decode.py``). ``jax.random.categorical`` draws Gumbel-max
over threefry bits; the port keeps the structure and fixes its own bits:

- the key of a draw is (rid, token index), the token index being
  ``len(request.output)`` before the token (JAX's ``_fold_keys``), and the
  engine key is 0, as JAX's ``PRNGKey(0)``;
- Philox4x32-10 with key ``(0, 0)`` and counter ``(v // 4, index, rid, 0)``
  gives word ``v % 4`` for vocabulary entry v;
- ``u = ((w >> 8) + 0.5) * 2**-24`` in (0, 1), ``g = -log(-log(u))`` in
  fp32, where ``-log(u)`` is taken as ``-log1p(-(1 - u))`` above 0.5 so
  that u keeps all its 24 bits;
- the token is ``argmax(float(logit) / max(T, 1e-6) + g)``, or
  ``argmax(logit)`` at ``T <= 0``; ties go to the lowest index
  (``torch.argmax``'s and ``jnp.argmax``'s rule). The floor is JAX's
  (``jnp.maximum(t, 1e-6)`` at every fused pick), in fp32.

So a draw has ``jax.random.categorical``'s distribution, not its bits.
The same kernel takes the greedy loops' argmax (``models.llama``,
``models.speculative``): all-greedy rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # logits, temps, rids
    ctypes.c_void_p, ctypes.c_void_p,                   # index, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # rows, v, splits
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,        # vec (FLAG_*), dtype, stream
]

_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
#: the blocks of a cluster that split a row, at most
MAX_SPLITS = 8
#: 4-element groups one rank of the cluster takes before the row is split
#: over one more doubling of the cluster: 4 for each of the 1024 threads an
#: SM holds at once (the kernel's ``kThreads``)
_GROUPS_PER_BLOCK = 1024 * 4
#: the kernel's block, and the blocks an SM holds at once
BLOCK_THREADS = 256
BLOCKS_PER_SM = 4
#: clusters of one row, at most; rows x clusters, at most, when a row has
#: more than one (so the rows fit the kernel's static slots, one a row)
MAX_CHUNKS = 16
MAX_PARTIALS = 2048
#: bits of the C entry's ``vec`` argument: the 16- (fp32) or 8-byte (bf16)
#: loads, and programmatic dependent launch
FLAG_VEC = 1
FLAG_PDL = 2
#: the least temperature a sampled row is divided by (fp32, as
#: ``jnp.maximum(t, 1e-6)`` sees it)
TEMP_FLOOR = 1e-6


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for ``a`` int64 in [0, 2**32):
    the product in 16-bit halves, so no int64 overflows."""
    al, ah = a & 0xFFFF, a >> 16
    p1, p2 = al * m, ah * m
    return (p2 + (p1 >> 16)) >> 16, (p1 + ((p2 & 0xFFFF) << 16)) & _MASK


def philox4x32(counter: torch.Tensor, key: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Philox4x32-10 (Random123) of int64 ``counter [..., 4]`` (words in
    [0, 2**32)) under ``key``; returns the int64 ``[..., 4]`` output words.
    Exact wherever int64 arithmetic is."""
    c0, c1, c2, c3 = counter.long().unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def gumbel_from_words(w: torch.Tensor) -> torch.Tensor:
    """fp32 ``-log(-log(u))`` of ``u = ((w >> 8) + 0.5) * 2**-24`` for int64
    words ``w`` in [0, 2**32): ``-log(u)`` from the exact distance ``m`` to
    the nearer end of (0, 1), ``-log(m)`` below 0.5 and ``-log1p(-m)``
    above (u itself needs 25 bits there)."""
    x = w >> 8
    upper = x >= (1 << 23)
    m = (torch.where(upper, 0xFFFFFF - x, x).float() + 0.5) * 2.0 ** -24  # exact: < 2**23
    return -torch.log(torch.where(upper, -torch.log1p(-m), -torch.log(m)))


def gumbel_noise(rids: torch.Tensor, index: torch.Tensor, v: int) -> torch.Tensor:
    """fp32 ``[R, v]``: the Gumbel noise of each row's (rid, token index)."""
    groups = -(-v // 4)
    g = torch.arange(groups, dtype=torch.long, device=rids.device)[None, :].expand(len(rids),
                                                                                  groups)
    counter = torch.stack([g, (index.long() & _MASK)[:, None].expand_as(g),
                           (rids.long() & _MASK)[:, None].expand_as(g), torch.zeros_like(g)],
                          dim=-1)
    return gumbel_from_words(philox4x32(counter).reshape(len(rids), 4 * groups)[:, :v])


def pick_tokens_reference(logits: torch.Tensor, temps: Optional[torch.Tensor] = None,
                          rids: Optional[torch.Tensor] = None,
                          index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: int32 ``[R]``, each row's argmax of its fp32
    logits, or at ``temps[r] > 0`` of ``logits / max(temps, 1e-6) +
    gumbel_noise`` (``temps`` None: every row greedy)."""
    scores = logits.float()
    if temps is not None:
        rows = (temps > 0).nonzero()[:, 0]
        if len(rows):
            scores = scores.clone()
            # clamp_min casts the floor to fp32 before it compares
            t = temps[rows].float().clamp_min(TEMP_FLOOR)
            scores[rows] = (scores[rows] / t[:, None]
                            + gumbel_noise(rids[rows], index[rows], scores.shape[-1]))
    return scores.argmax(dim=-1).to(torch.int32)


def pick_splits(v: int) -> int:
    """The cluster size that splits a row of ``v`` logits: one block per
    ``_GROUPS_PER_BLOCK`` groups of 4, in powers of two up to 8 (8 at
    Llama-3's 128,256)."""
    splits = 1
    while splits < MAX_SPLITS and splits * _GROUPS_PER_BLOCK < -(-v // 4):
        splits *= 2
    return splits


def pick_chunks(rows: int, v: int, sms: int) -> int:
    """The clusters that split one row of ``v`` logits in a pick of
    ``rows`` rows on a card of ``sms`` SMs (the C entry's ``chunks_for``):
    rows x splits x chunks blocks come to about ``BLOCKS_PER_SM`` an SM (to
    the nearest), a block keeps at least one group of 4 a thread, at most
    ``MAX_CHUNKS``, and rows x chunks within ``MAX_PARTIALS``; at least 1.
    8 for an engine step's ``[8, 128256]`` on the H100's 132 SMs."""
    splits = pick_splits(v)
    rs = rows * splits
    c = (2 * sms * BLOCKS_PER_SM + rs) // (2 * rs)
    c = min(c, -(-v // 4) // (splits * BLOCK_THREADS), MAX_CHUNKS, MAX_PARTIALS // rows)
    return max(c, 1)


def pick_tokens_cuda(logits: torch.Tensor, temps: Optional[torch.Tensor] = None,
                     rids: Optional[torch.Tensor] = None,
                     index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/pick_tokens.cu`` on ``logits [R, V]`` (fp32 or bf16,
    contiguous, on a card): int32 ``[R]``. ``temps`` fp32, ``rids`` and
    ``index`` int32, each ``[R]`` contiguous on the same card, or all three
    None (every row greedy). Raises on anything else; it never computes the
    plain version instead.

    Not re-entrant: a row's clusters combine through one static scratch per
    card, so the picks on one card must be ordered, as the port launches
    them (one stream at a time; captured graphs replayed one after another).
    Two picks in flight at once on two streams would mix their rows."""
    refuse_grad("pick_tokens_cuda", logits)
    if logits.dtype not in KERNEL_DTYPES:
        raise TypeError(f"pick_tokens_cuda takes float32 or bfloat16 logits, got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] < 1 or not 1 <= logits.shape[0] <= 65535:
        raise ValueError(f"pick_tokens_cuda takes logits [R, V] with 1 <= R <= 65535 and V >= 1, "
                         f"got {tuple(logits.shape)}")
    keyed = (temps, rids, index)
    if any(t is None for t in keyed) and not all(t is None for t in keyed):
        raise ValueError("pick_tokens_cuda takes temps, rids and index together, or none")
    rows, v = logits.shape
    dev = logits.get_device()
    if not logits.is_cuda:
        raise ValueError(f"pick_tokens_cuda needs logits on a CUDA device, got {logits.device}")
    if temps is not None:
        for name, t, dt in (("temps", temps, torch.float32), ("rids", rids, torch.int32),
                            ("index", index, torch.int32)):
            if t.dtype != dt or tuple(t.shape) != (rows,):
                raise ValueError(f"pick_tokens_cuda: {name} must be {dt} [{rows}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.get_device() != dev or not t.is_contiguous():
                raise ValueError(f"pick_tokens_cuda: {name} must be contiguous on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("pick_tokens_cuda needs contiguous logits")
    out = torch.empty((rows,), dtype=torch.int32, device=logits.device)
    flags = ((FLAG_VEC if v % 4 == 0 and logits.data_ptr() % 16 == 0 else 0)
             | (FLAG_PDL if pick_tokens_cuda.pdl else 0))
    fn = kernel_function("bobra_pick_tokens", _ARGTYPES)
    ptrs = [None if t is None else t.data_ptr() for t in keyed]
    check_launch("pick_tokens", launch(fn, dev, logits.data_ptr(), *ptrs, out.data_ptr(), rows,
                                       v, pick_splits(v), flags, KERNEL_DTYPES[logits.dtype]))
    pick_tokens_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
pick_tokens_cuda.launches = 0
#: launch with programmatic dependent launch (the pick's blocks are placed
#: while the kernel before it, the LM head's cast, ends)
pick_tokens_cuda.pdl = True


def pick_tokens(logits: torch.Tensor, temps: Optional[torch.Tensor] = None,
                rids: Optional[torch.Tensor] = None,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: the plain version for CPU logits, the kernel otherwise."""
    if logits.device.type == "cpu":
        return pick_tokens_reference(logits, temps, rids, index)
    return pick_tokens_cuda(logits, temps, rids, index)
