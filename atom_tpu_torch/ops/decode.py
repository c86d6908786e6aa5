"""Paged + hot-ring decode attention and the ring flush
(``atom_tpu/ops/pallas_decode.py``), kernels K3, K4 and K11.

``paged_ring_decode_attention`` (K3) attends each sequence's query heads
over its flushed pages and the valid suffix of the hot ring, on 4-bit codes
with the affine dequantization folded into the scores and the probabilities.
``flush_hot_ring`` (K4) writes each active sequence's pending ring block
``[lo, hi)`` into its one or two pages, in place, reading the live ring in
place (block token t is ring column ``(row + 1 + t) mod W``); ``flush_hot``
takes the block pre-rolled into position order, as the JAX kernel does.
``paged_decode_attention_rotated`` (K11) is K3 without the ring: attention
over the flushed pages alone, which can also return the softmax state (m, l)
so that a caller merges it with another part (``kv_hot.merge_attention``);
the mixed prefill+decode step calls it for the decode rows and, with all of a
prompt chunk's queries folded into the query-head axis, for the chunk's
page-resident prefix.  All launch ``csrc/decode.cu`` on CUDA tensors and run
their plain versions on CPU tensors.

K3 runs one block per (sequence, kv head): an online softmax over the ring,
then the sequence's pages, streamed through shared memory.  K11 takes one of
two paths on the card, from the shapes alone (``check_rotated_decode_shape``):
up to 8 query rows per kv head K3's kernel without the ring ("stream"), above
it tiles of 64 query rows on the tensor cores ("tile").
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.kv_hot import HotKV, hot_flush_blocks
from atom_tpu_torch.ops.kv_layout import KVPages
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu

_NEG_INF = -1e30
_GMAX = 8  # query rows per kv head of K3 and of K11's stream path
_CHUNK_LANES = (16, 512)  # K3's page size and ring width: powers of two in this range
_TILE_LANES = (64, 512)  # K11's tile path: page sizes, powers of two in this range

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("decode")
    lib.atom_paged_ring_decode.argtypes = [_P] * 11 + [_I] * 7 + [_F, _P]
    lib.atom_paged_ring_decode.restype = _I
    lib.atom_flush_hot.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    lib.atom_flush_hot.restype = _I
    lib.atom_paged_decode.argtypes = [_P] * 9 + [_I] * 6 + [_F, _P]
    lib.atom_paged_decode.restype = _I
    return lib


def _planes(b: torch.Tensor, dim: int) -> torch.Tensor:
    """u4 plane bytes -> codes f32, low nibbles first along ``dim``."""
    u = b.to(torch.int32) & 0xFF
    return torch.cat([u & 0x0F, u >> 4], dim=dim).to(torch.float32)


def _gather_pages(pages: KVPages, page_table, seq_lens):
    """Each sequence's pages as float32 codes for the plain versions -> (K
    codes [B, P, H, D, S], params [B, H, 4, P, S], V codes [B, P, H, S, D],
    slot validity [B, P, S]).  Pages past a sequence's last one are clamped
    to it (and masked)."""
    s = pages.page_size
    max_pages = page_table.shape[1]
    dev = page_table.device
    last = torch.clamp_min((seq_lens + s - 1) // s - 1, 0)
    idx = torch.minimum(torch.arange(max_pages, device=dev)[None, :], last[:, None])
    pt = torch.gather(page_table, 1, idx).long()  # [B, P]
    kc = _planes(pages.k_pages[pt], dim=-2)
    prm = pages.params[pt].to(torch.float32).permute(0, 3, 2, 1, 4)
    vc = _planes(pages.v_pages[pt], dim=-2)
    pos = torch.arange(max_pages * s, device=dev).reshape(max_pages, s)
    return kc, prm, vc, pos[None] < seq_lens[:, None, None]


def paged_ring_decode_attention_plain(q, pages: KVPages, page_table, seq_lens, hot: HotKV, n_hot, row: int):
    """Plain version of K3: one masked softmax over ring lanes and page slots."""
    b, hq, d = q.shape
    h, s, w = pages.kv_heads, pages.page_size, hot.window
    g = hq // h
    max_pages = page_table.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, h, g, d)
    q_sum = qf.sum(-1)  # [B, H, G]

    kc, prm, vc, valid_p = _gather_pages(pages, page_table, seq_lens)
    dots = torch.einsum("bhgd,bphds->bhgps", qf, kc)
    sc_p = (dots * prm[:, :, None, 0] + q_sum[..., None, None] * prm[:, :, None, 1]) * sm_scale
    sc_p = torch.where(valid_p[:, None, None], sc_p, _NEG_INF).reshape(b, h, g, max_pages * s)

    rk = _planes(hot.k_codes, dim=-2)  # [B, H, D, W]
    rprm = hot.prm.to(torch.float32)  # [B, 4, H, W]
    cols = torch.arange(w, device=q.device)
    valid_r = ((row - cols + w) % w)[None, :] < n_hot[:, None]  # [B, W]
    dots_r = torch.einsum("bhgd,bhdw->bhgw", qf, rk)
    sc_r = (dots_r * rprm[:, 0, :, None] + q_sum[..., None] * rprm[:, 1, :, None]) * sm_scale
    sc_r = torch.where(valid_r[:, None, None], sc_r, _NEG_INF)

    scores = torch.cat([sc_r, sc_p], dim=-1)  # [B, H, G, W + P*S]
    valid = torch.cat([valid_r, valid_p.reshape(b, -1)], dim=-1)[:, None, None]
    m = scores.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1)
    p_r, p_p = p[..., :w], p[..., w:].reshape(b, h, g, max_pages, s)
    pv = torch.einsum("bhgw,bhwd->bhgd", p_r * rprm[:, 2, :, None], hot.v_codes.to(torch.float32))
    pv = pv + torch.einsum("bhgps,bphsd->bhgd", p_p * prm[:, :, None, 2], vc)
    z = (p_r * rprm[:, 3, :, None]).sum(-1) + (p_p * prm[:, :, None, 3]).sum((-2, -1))
    out = (pv + z[..., None]) / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, hq, d).to(torch.bfloat16)


def _pow2_lanes(x: int, lanes=_CHUNK_LANES) -> bool:
    return lanes[0] <= x <= lanes[1] and x & (x - 1) == 0


def check_ring_decode_shape(window: int, page_size: int, q_heads: int, kv_heads: int) -> None:
    """Raises on a shape K3 does not take: page size and ring width powers of
    two in [16, 512], at most 8 query heads per kv head."""
    if not (_pow2_lanes(page_size) and _pow2_lanes(window)):
        raise ValueError(
            f"paged_ring_decode_attention: page size {page_size} and ring width {window} must be powers "
            f"of two in [{_CHUNK_LANES[0]}, {_CHUNK_LANES[1]}]"
        )
    if kv_heads < 1 or q_heads % kv_heads or q_heads // kv_heads > _GMAX:
        raise ValueError(
            f"paged_ring_decode_attention: needs at most {_GMAX} query heads per kv head, got HQ={q_heads}, H={kv_heads}"
        )


def paged_ring_decode_attention(
    q: torch.Tensor,  # bf16 [B, HQ, D] — RoPE'd, kv-head-major
    pages: KVPages,  # K pages hold post-RoPE codes
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — flushed tokens per sequence
    hot: HotKV,
    n_hot: torch.Tensor,  # int32 [B] — ring-resident suffix lengths
    row: int,  # ring column of the current token
) -> torch.Tensor:
    """Kernel K3 -> normalised attention output bf16 [B, HQ, D]."""
    tensors = (q, *pages, page_table, seq_lens, *hot, n_hot)
    if on_cpu(*tensors):
        return paged_ring_decode_attention_plain(q, pages, page_table, seq_lens, hot, n_hot, row)
    b, hq, d = q.shape
    h, s, w = pages.kv_heads, pages.page_size, hot.window
    if d != 128:
        raise ValueError(f"paged_ring_decode_attention: needs head_dim 128, got D={d}")
    max_pages = page_table.shape[1]
    check_ring_decode_shape(w, s, hq, h)
    if not 0 <= row < w:
        raise ValueError(f"ring row {row} outside [0, {w})")
    check_kernel_input(q, "q", torch.bfloat16)
    check_kernel_input(pages.k_pages, "k_pages", torch.int8)
    check_kernel_input(pages.params, "params", torch.bfloat16)
    check_kernel_input(pages.v_pages, "v_pages", torch.int8)
    check_kernel_input(page_table, "page_table", torch.int32, (b, max_pages))
    check_kernel_input(seq_lens, "seq_lens", torch.int32, (b,))
    check_kernel_input(hot.k_codes, "ring k", torch.int8, (b, h, d // 2, w))
    check_kernel_input(hot.prm, "ring prm", torch.bfloat16, (b, 4, h, w))
    check_kernel_input(hot.v_codes, "ring v", torch.int8, (b, h, w, d))
    check_kernel_input(n_hot, "n_hot", torch.int32, (b,))
    out = torch.empty_like(q)
    _build.check(
        _lib().atom_paged_ring_decode(
            q.data_ptr(), pages.k_pages.data_ptr(), pages.params.data_ptr(), pages.v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), hot.k_codes.data_ptr(), hot.prm.data_ptr(),
            hot.v_codes.data_ptr(), n_hot.data_ptr(), out.data_ptr(),
            b, hq, h, s, w, max_pages, row, 1.0 / math.sqrt(d), _build.stream(),
        ),
        "paged_ring_decode_attention",
    )
    paged_ring_decode_attention.launches += 1
    return out


paged_ring_decode_attention.launches = 0


def flush_hot_plain(pages: KVPages, k_flush, prm_flush, v_flush, page_a, page_b, slot0, o, lo, hi) -> KVPages:
    """Plain version of K4: write the valid lanes of each ring block, in place."""
    bsz, _, _, w = k_flush.shape
    s = pages.page_size
    t = torch.arange(w, device=k_flush.device)[None, :]
    gslot = (slot0 + o)[:, None] + t  # [B, W] global slot of each block token
    for pass_i, pg in enumerate((page_a, page_b)):
        lane = gslot - (slot0[:, None] + pass_i * s)
        valid = (lane >= 0) & (lane < s) & (gslot >= lo[:, None]) & (gslot < hi[:, None])
        bi, ti = valid.nonzero(as_tuple=True)
        p, ln = pg[bi].long(), lane[bi, ti]
        pages.k_pages[p, :, :, ln] = k_flush[bi, :, :, ti]
        pages.params[p, :, :, ln] = prm_flush[bi, :, :, ti]
        r = ln % (s // 2)
        old = pages.v_pages[p, :, r, :].to(torch.int32) & 0xFF  # [n, H, D]
        new = v_flush[bi, :, ti, :].to(torch.int32) & 0x0F
        high = (ln >= s // 2)[:, None, None]
        merged = torch.where(high, (old & 0x0F) | (new << 4), (old & 0xF0) | new)
        pages.v_pages[p, :, r, :] = merged.to(torch.uint8).view(torch.int8)
    return pages


def _flush_launch(pages: KVPages, k_ring, prm_ring, v_ring, book, roll: int, path: str, name: str) -> KVPages:
    """K4 on the card: block token t from ring column ``(roll + t) mod W``."""
    bsz, h, _, w = k_ring.shape
    s, d = pages.page_size, pages.head_dim
    if 2 * w > s:
        raise ValueError(f"{name}: ring width {w} must be at most half the page size {s}")
    check_kernel_input(k_ring, "k ring", torch.int8, (bsz, h, d // 2, w))
    check_kernel_input(prm_ring, "prm ring", torch.bfloat16, (bsz, 4, h, w))
    check_kernel_input(v_ring, "v ring", torch.int8, (bsz, h, w, d))
    for arg, t in zip(("page_a", "page_b", "slot0", "o", "lo", "hi"), book):
        check_kernel_input(t, arg, torch.int32, (bsz,))
    check_kernel_input(pages.k_pages, "k_pages", torch.int8)
    check_kernel_input(pages.params, "params", torch.bfloat16)
    check_kernel_input(pages.v_pages, "v_pages", torch.int8)
    _build.check(
        _lib().atom_flush_hot(
            k_ring.data_ptr(), prm_ring.data_ptr(), v_ring.data_ptr(), *(t.data_ptr() for t in book),
            pages.k_pages.data_ptr(), pages.params.data_ptr(), pages.v_pages.data_ptr(),
            bsz, h, s, w, d, roll, _build.stream(),
        ),
        name,
    )
    flush_hot.launches += 1
    flush_hot.launches_by_path[path] += 1
    return pages


def flush_hot(
    pages: KVPages,
    k_flush: torch.Tensor,  # int8 [B, H, D/2, W] channel-plane bytes, position order
    prm_flush: torch.Tensor,  # bf16 [B, 4, H, W]
    v_flush: torch.Tensor,  # int8 [B, H, W, D] unpacked u4
    page_a: torch.Tensor,  # int32 [B] — page of block lanes [0, S) (0 = sink)
    page_b: torch.Tensor,  # int32 [B] — page of block lanes [S, 2S) (0 = sink)
    slot0: torch.Tensor,  # int32 [B] — global slot of page_a's lane 0
    o: torch.Tensor,  # int32 [B] in [0, S): lane of the block's token 0
    lo: torch.Tensor,  # int32 [B] — first slot to write (flushed before)
    hi: torch.Tensor,  # int32 [B] — one past the last (the sequence length)
) -> KVPages:
    """Kernel K4 on pre-rolled blocks (the JAX kernel's signature): write
    each sequence's pending ring block into its page(s), in place; returns
    ``pages``.  A sequence holds at most W ring tokens (``lo >= hi - W``)."""
    book = (page_a, page_b, slot0, o, lo, hi)
    if on_cpu(*pages, k_flush, prm_flush, v_flush, *book):
        return flush_hot_plain(pages, k_flush, prm_flush, v_flush, *book)
    return _flush_launch(pages, k_flush, prm_flush, v_flush, book, 0, "rolled", "flush_hot")


flush_hot.launches = 0
flush_hot.launches_by_path = {"ring": 0, "rolled": 0}


def flush_hot_ring_plain(pages: KVPages, hot: HotKV, row: int, page_a, page_b, slot0, o, lo, hi) -> KVPages:
    """Plain version of :func:`flush_hot_ring`: the ring rolled into position
    order (three copies), then the plain flush."""
    return flush_hot_plain(pages, *hot_flush_blocks(hot, row), page_a, page_b, slot0, o, lo, hi)


def flush_hot_ring(
    pages: KVPages,
    hot: HotKV,  # the live ring; ``row`` its newest column
    row: int,
    page_a: torch.Tensor,
    page_b: torch.Tensor,
    slot0: torch.Tensor,
    o: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
) -> KVPages:
    """Kernel K4 on the live ring: what ``flush_hot(pages,
    *hot_flush_blocks(hot, row), ...)`` writes, bit for bit, with block token
    t read from ring column ``(row + 1 + t) mod W`` in place of three rolled
    copies of the ring.  Counts on ``flush_hot.launches`` (path "ring")."""
    book = (page_a, page_b, slot0, o, lo, hi)
    if on_cpu(*pages, *hot, *book):
        return flush_hot_ring_plain(pages, hot, row, *book)
    w = hot.window
    if not 0 <= row < w:
        raise ValueError(f"flush_hot_ring: ring row {row} outside [0, {w})")
    return _flush_launch(pages, *hot, book, (row + 1) % w, "ring", "flush_hot_ring")


def paged_decode_attention_rotated_plain(q, pages: KVPages, page_table, seq_lens, out_dtype=torch.bfloat16,
                                         return_state: bool = False):
    """Plain version of K11: one masked softmax over the page slots; an empty
    sequence gives ``out = 0, m = -1e30, l = 0``."""
    b, hq, d = q.shape
    h = pages.kv_heads
    g = hq // h
    sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, h, g, d)
    q_sum = qf.sum(-1)  # [B, H, G]

    kc, prm, vc, valid = _gather_pages(pages, page_table, seq_lens)
    valid = valid[:, None, None]  # [B, 1, 1, P, S]
    dots = torch.einsum("bhgd,bphds->bhgps", qf, kc)
    scores = (dots * prm[:, :, None, 0] + q_sum[..., None, None] * prm[:, :, None, 1]) * sm_scale
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax((-2, -1))  # [B, H, G]
    p = torch.where(valid, torch.exp(scores - m[..., None, None]), 0.0)
    l = p.sum((-2, -1))
    pv = torch.einsum("bhgps,bphsd->bhgd", p * prm[:, :, None, 2], vc)
    z = (p * prm[:, :, None, 3]).sum((-2, -1))
    out = ((pv + z[..., None]) / torch.clamp_min(l, 1e-20)[..., None]).reshape(b, hq, d).to(out_dtype)
    if return_state:
        return out, m.reshape(b, hq), l.reshape(b, hq)
    return out


def check_rotated_decode_shape(page_size: int, q_heads: int, kv_heads: int, head_dim: int = 128) -> str:
    """The path K11 takes on the card for a shape, or a ``ValueError``: head
    dim 128 and HQ a multiple of H; up to 8 query rows per kv head "stream"
    (K3's kernel without the ring; page size a power of two in [16, 512]),
    above it "tile" (tiles of 64 query rows; page size a power of two in
    [64, 512])."""
    if head_dim != 128 or kv_heads < 1 or q_heads < 1 or q_heads % kv_heads:
        raise ValueError(f"paged_decode_attention_rotated: needs head_dim 128 and HQ a multiple of H, "
                         f"got D={head_dim}, HQ={q_heads}, H={kv_heads}")
    path, lanes = ("stream", _CHUNK_LANES) if q_heads // kv_heads <= _GMAX else ("tile", _TILE_LANES)
    if not _pow2_lanes(page_size, lanes):
        raise ValueError(f"paged_decode_attention_rotated: the {path} path needs a page size that is a power of two "
                         f"in [{lanes[0]}, {lanes[1]}], got {page_size} at {q_heads // kv_heads} query rows per kv head")
    return path


def paged_decode_attention_rotated(
    q: torch.Tensor,  # bf16 [B, HQ, D] — RoPE'd, kv-head-major
    pages: KVPages,  # K pages hold post-RoPE codes
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — flushed tokens per sequence
    out_dtype=torch.bfloat16,  # or torch.float32
    return_state: bool = False,
):
    """Kernel K11 -> attention over the pages alone, normalised by
    ``max(l, 1e-20)``, [B, HQ, D] in ``out_dtype``; with ``return_state``
    also the softmax state (m f32 [B, HQ], l f32 [B, HQ]).  Any number of
    query heads per kv head: a prompt chunk's C queries ride as ``G * C``
    query rows of one sequence (the tile path on the card)."""
    tensors = (q, *pages, page_table, seq_lens)
    if on_cpu(*tensors):
        return paged_decode_attention_rotated_plain(q, pages, page_table, seq_lens, out_dtype, return_state)
    b, hq, d = q.shape
    h, s = pages.kv_heads, pages.page_size
    path = check_rotated_decode_shape(s, hq, h, d)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_decode_attention_rotated: out_dtype {out_dtype} is neither bfloat16 nor float32")
    check_kernel_input(q, "q", torch.bfloat16)
    check_kernel_input(pages.k_pages, "k_pages", torch.int8)
    check_kernel_input(pages.params, "params", torch.bfloat16)
    check_kernel_input(pages.v_pages, "v_pages", torch.int8)
    check_kernel_input(page_table, "page_table", torch.int32, (b, page_table.shape[1]))
    check_kernel_input(seq_lens, "seq_lens", torch.int32, (b,))
    out = torch.empty((b, hq, d), dtype=out_dtype, device=q.device)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    _build.check(
        _lib().atom_paged_decode(
            q.data_ptr(), pages.k_pages.data_ptr(), pages.params.data_ptr(), pages.v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, hq, h, s, page_table.shape[1], int(out_dtype == torch.float32), 1.0 / math.sqrt(d), _build.stream(),
        ),
        "paged_decode_attention_rotated",
    )
    paged_decode_attention_rotated.launches += 1
    paged_decode_attention_rotated.launches_by_path[path] += 1
    if return_state:
        return out, m, l
    return out


paged_decode_attention_rotated.launches = 0
paged_decode_attention_rotated.launches_by_path = {"stream": 0, "tile": 0}
