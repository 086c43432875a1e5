"""What surrounds the two tensor-core kernels, in Python that the CPU tests
reach: the tiling arithmetic of the bf16 GEMM (``csrc/gemm.cu``) and the
schedule of the bf16 attention (``csrc/attention.cu``), tile by tile.

The CUDA sources cannot run without a card, so everything that can be wrong
outside them lives here: :func:`gemm_bf16_plan` is what
``primitives.gemm_cuda`` consults before a launch (which tile width, the
grid, the TMA boxes, what it refuses), and :func:`attention_emulated` walks
the attention kernel's schedule in plain PyTorch (the same blocks, warp
tiles, key chunks, skipped score tiles, padded head, score arithmetic and
rounding points) so that the schedule itself is held against
``attention_plain`` and against the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------- bf16 GEMM

GEMM_TILE_M = 128        # rows of an output tile: two warpgroups of 64
GEMM_TILE_K = 64         # depth of one stage: 128 bytes of bf16, one swizzle atom
GEMM_TILES_N = (256, 128)
GEMM_STORE_BOX = (64, 64)  # columns x rows of one TMA store out of the staging tile
H100_SMS = 132
_SMEM_LIMIT = 232448     # bytes of shared memory a block may opt in to
# the wide tile pads N further than the narrow one; it is still taken while
# the extra padding stays under this share (on an H100 it multiplies about 10 %
# faster per useful product: N = 4224 pads 3 % and takes 256, 1408 pads 9 %
# and takes 128)
_WIDE_TILE_EXTRA_PADDING = 0.05


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def gemm_bf16_plan(M: int, N: int, K: int, act: Optional[str] = None, sms: int = H100_SMS) -> dict:
    """How the bf16 GEMM kernel cuts ``[M, K] x [N, K] -> [M, N]``.

    ``tile_n`` is 256, or 128 where 256 would pad N by 5 % more (EVA's 1408 =
    11 x 128 = 5.5 x 256) and whenever the epilogue holds an activation (its
    arithmetic runs while the tensor cores wait, and half the sums per thread
    keep that wait short). The X map's box is ``tile_k`` columns by ``tile_m``
    rows, the W map's ``tile_k`` by ``tile_n``; a box may hang over the
    tensor's edge (TMA fills what lies outside with zeros), so any M >= 1,
    N >= 1 and K >= 8 is taken as long as a row is a whole number of 16-byte
    units (``K % 8 == 0``), which TMA needs for its row pitch. The output
    leaves through TMA stores where ``N % 8 == 0`` (``y_tma``), else straight
    from the registers. ``grid``: one persistent block per SM, or per tile
    where there are fewer. Raises ``ValueError`` on anything else. The result
    is cached: treat it as read-only."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"gemm: empty product M={M} N={N} K={K}")
    if K % 8:
        raise ValueError(f"gemm: the bf16 kernel reads 16-byte rows: K % 8 == 0, got K={K}")
    if max(M * K, N * K, M * N) >= 2 ** 31:
        raise ValueError("gemm: tensor too large for 32-bit indexing")
    wide, narrow = GEMM_TILES_N
    padded = {t: _ceil_div(N, t) * t for t in GEMM_TILES_N}
    tile_n = wide if act is None and padded[wide] <= padded[narrow] * (
        1.0 + _WIDE_TILE_EXTRA_PADDING) else narrow
    tiles_m, tiles_n = _ceil_div(M, GEMM_TILE_M), _ceil_div(N, tile_n)
    stage_bytes = 2 * GEMM_TILE_K * (GEMM_TILE_M + tile_n)
    stages = 3 if tile_n == 256 else 5
    staging_bytes = 2 * GEMM_TILE_M * tile_n
    smem = stages * stage_bytes + staging_bytes + 1024  # stages on a 1024-byte boundary
    assert smem <= _SMEM_LIMIT
    return {
        "tile_m": GEMM_TILE_M, "tile_n": tile_n, "tile_k": GEMM_TILE_K,
        "tiles_m": tiles_m, "tiles_n": tiles_n, "tiles": tiles_m * tiles_n,
        "grid": min(tiles_m * tiles_n, sms),
        "k_steps": _ceil_div(K, GEMM_TILE_K), "stages": stages,
        "stage_bytes": stage_bytes, "staging_bytes": staging_bytes, "smem_bytes": smem,
        # tensor maps: (dims innermost first, row pitch in bytes, box innermost first)
        "x_map": {"dims": (K, M), "pitch": 2 * K, "box": (GEMM_TILE_K, GEMM_TILE_M)},
        "w_map": {"dims": (K, N), "pitch": 2 * K, "box": (GEMM_TILE_K, tile_n)},
        "y_tma": N % 8 == 0,
        "y_map": {"dims": (N, M), "pitch": 2 * N, "box": GEMM_STORE_BOX} if N % 8 == 0 else None,
        # the valid part of the last tile along each axis
        "last_rows": M - (tiles_m - 1) * GEMM_TILE_M,
        "last_cols": N - (tiles_n - 1) * tile_n,
        "last_depth": K - (_ceil_div(K, GEMM_TILE_K) - 1) * GEMM_TILE_K,
        # computed over useful products
        "padding": tiles_m * GEMM_TILE_M * tiles_n * tile_n / (M * N) - 1.0,
    }


def gemm_tiles_of_block(plan: dict, block: int) -> list:
    """(first row, first column) of every tile that persistent block ``block``
    walks over, in order: tile ``block``, then every ``grid``-th after it; the
    column tiles of one row band are numbered consecutively, so the blocks in
    flight share a few bands of X and all of W."""
    return [((t // plan["tiles_n"]) * plan["tile_m"], (t % plan["tiles_n"]) * plan["tile_n"])
            for t in range(block, plan["tiles"], plan["grid"])]


def gemm_staging_offset(row: int, col: int) -> int:
    """Byte offset, inside one warpgroup's part of the staging tile, of output
    element (``row`` of its 64, ``col`` of the tile): 64-column boxes of 64
    rows x 128 bytes, the 16-byte chunks of a row permuted by the 128-byte
    swizzle (chunk ^ row % 8), which is the layout a TMA store with
    ``SWIZZLE_128B`` reads."""
    box, chunk, within = col // 64, (col % 64) // 8, col % 8
    return box * 64 * 128 + row * 128 + ((chunk ^ (row % 8)) * 16) + within * 2


# ----------------------------------------------------------- bf16 attention

ATTN_WARPS = 6           # warps of a block
ATTN_WARP_ROWS = 16      # query rows of a warp: the M of mma.m16n8k16
ATTN_BLOCK_ROWS = ATTN_WARPS * ATTN_WARP_ROWS
ATTN_KEY_CHUNK = 64      # keys of one shared-memory stage
ATTN_SCORE_TILE = 8      # keys of one score tile: the N of the first product
ATTN_PV_STEP = 16        # keys of one step of the second product: its depth
LOG2E = 1.4426950408889634


def attention_tiles(Sq: int, Sk: int) -> dict:
    """The attention kernel's tiling of an ``Sq x Sk`` score matrix: blocks
    along the queries, warp tiles that hold a valid row, and per key chunk the
    score tiles and P V steps that hold a valid key (the others are skipped).
    ``padding_qk`` / ``padding_pv``: computed over useful products, minus 1."""
    if Sq < 1 or Sk < 1:
        raise ValueError(f"attention: needs at least one query and one key, got {Sq} x {Sk}")
    blocks = _ceil_div(Sq, ATTN_BLOCK_ROWS)
    warp_tiles = _ceil_div(Sq, ATTN_WARP_ROWS)
    chunks = []
    for c0 in range(0, Sk, ATTN_KEY_CHUNK):
        kv = min(ATTN_KEY_CHUNK, Sk - c0)
        # score tiles come in pairs (one ldmatrix feeds two)
        tiles = 2 * _ceil_div(kv, 2 * ATTN_SCORE_TILE)
        chunks.append({"first_key": c0, "valid": kv, "score_tiles": tiles,
                       "softmax_tiles": _ceil_div(kv, ATTN_SCORE_TILE),
                       "pv_steps": _ceil_div(kv, ATTN_PV_STEP)})
    rows = warp_tiles * ATTN_WARP_ROWS
    qk_cols = sum(c["score_tiles"] for c in chunks) * ATTN_SCORE_TILE
    pv_keys = sum(c["pv_steps"] for c in chunks) * ATTN_PV_STEP
    return {"blocks": blocks, "warp_tiles": warp_tiles, "chunks": chunks,
            "padding_qk": rows * qk_cols / (Sq * Sk) - 1.0,
            "padding_pv": rows * pv_keys / (Sq * Sk) - 1.0}


def attention_emulated(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                       col_bias: Optional[Tensor] = None) -> Tensor:
    """``attention_plain``'s function computed the way the bf16 kernel of
    ``csrc/attention.cu`` schedules it, for any float dtype: per warp tile of
    16 query rows, an online softmax over key chunks of 64 in which only the
    score tiles and P V steps with a valid key are computed; the head padded
    with zero lanes to a multiple of 16; ``s = (q . k) * scale + bias`` with
    two fp32 roundings, keys past Sk at -inf; ``p = exp2((s - m) * log2 e)``;
    the probabilities rounded to the model dtype unnormalised, their sum taken
    in fp32 before the rounding, and the division after ``P V``.
    q [B, Sq, H*D], k/v [B, Sk, H*D], col_bias [B, Sk] fp32 -> [B, Sq, H*D]."""
    B, Sq, W = q.shape
    Sk = k.shape[1]
    D = W // heads
    DP = _ceil_div(D, 16) * 16
    tiles = attention_tiles(Sq, Sk)
    f32 = torch.float32

    def padded(t, rows):  # [B, S, H*D] -> [B, H, rows, DP], zero rows and lanes beyond
        S = t.shape[1]
        out = torch.zeros(B, heads, rows, DP, dtype=t.dtype)
        out[:, :, :S, :D] = t.reshape(B, S, heads, D).permute(0, 2, 1, 3)
        return out

    rows_p = tiles["warp_tiles"] * ATTN_WARP_ROWS
    keys_p = len(tiles["chunks"]) * ATTN_KEY_CHUNK
    qp, kp, vp = padded(q, rows_p), padded(k, keys_p), padded(v, keys_p)
    add = torch.full((B, keys_p), -math.inf, dtype=f32)
    add[:, :Sk] = 0.0 if col_bias is None else col_bias.to(f32)
    out = torch.empty(B, heads, rows_p, D, dtype=q.dtype)
    scale32 = torch.tensor(scale, dtype=f32)
    for w in range(tiles["warp_tiles"]):
        r = slice(w * ATTN_WARP_ROWS, (w + 1) * ATTN_WARP_ROWS)
        qw = qp[:, :, r].to(f32)
        m = torch.full((B, heads, ATTN_WARP_ROWS, 1), -math.inf, dtype=f32)
        l = torch.zeros_like(m)
        o = torch.zeros(B, heads, ATTN_WARP_ROWS, D, dtype=f32)
        for ch in tiles["chunks"]:
            c0 = ch["first_key"]
            n_soft = ch["softmax_tiles"] * ATTN_SCORE_TILE   # columns that reach the softmax
            n_pv = ch["pv_steps"] * ATTN_PV_STEP             # keys of the second product
            assert n_soft <= ch["score_tiles"] * ATTN_SCORE_TILE and n_soft <= n_pv
            ks = kp[:, :, c0:c0 + n_soft].to(f32)
            s = torch.matmul(qw, ks.transpose(-1, -2)) * scale32 + add[:, None, None, c0:c0 + n_soft]
            m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
            corr = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new) * LOG2E)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = torch.zeros(B, heads, ATTN_WARP_ROWS, n_pv, dtype=q.dtype)
            pv[..., :n_soft] = p.to(q.dtype)  # a skipped score tile inside a step: zeros
            o = o * corr + torch.matmul(pv.to(f32), vp[:, :, c0:c0 + n_pv, :D].to(f32))
            m = m_new
        out[:, :, r] = (o / l).to(q.dtype)
    return out[:, :, :Sq].permute(0, 2, 1, 3).reshape(B, Sq, W)
