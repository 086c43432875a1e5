"""What surrounds the hand-written GEMM and attention kernels, in Python that
the CPU tests reach: the tiling arithmetic of the three GEMMs (bf16 and fp32
in ``csrc/gemm.cu``, s8 in ``csrc/gemm_i8.cu``) and the schedule of the bf16
attention (``csrc/attention.cu``), tile by tile.

The CUDA sources cannot run without a card, so everything that can be wrong
outside them lives here: :func:`gemm_bf16_plan`, :func:`gemm_i8_plan` and
:func:`gemm_f32_plan` are what ``primitives.gemm_cuda`` and
``primitives.gemm_i8_cuda`` consult before a launch (which tile, the grid,
the TMA boxes, what they refuse), and :func:`attention_emulated` walks
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


def gemm_staging_offset(row: int, col: int, elt: int = 2) -> int:
    """Byte offset, inside one warpgroup's part of the staging tile, of output
    element (``row`` of its 64, ``col`` of the tile) of ``elt`` bytes (2: the
    bf16 outputs of both GEMMs, 1: the s8 GEMM's int8 codes): boxes of 64 rows
    x 128 bytes (64 or 128 columns), the 16-byte chunks of a row permuted by
    the 128-byte swizzle (chunk ^ row % 8), which is the layout a TMA store
    with ``SWIZZLE_128B`` reads."""
    b = col * elt
    box, chunk, within = b // 128, (b % 128) // 16, b % 16
    return box * 64 * 128 + row * 128 + ((chunk ^ (row % 8)) * 16) + within


# ----------------------------------------------------------------- s8 GEMM

GEMM_I8_TILE_K = 128     # depth of one stage: 128 int8 values, 128 bytes, one swizzle atom
GEMM_I8_OUTS = ("s32", "f32", "bf16", "s8")  # the output modes, in the order of their codes


@functools.lru_cache(maxsize=256)
def gemm_i8_plan(M: int, N: int, K: int, out: str = "s32", act: Optional[str] = None,
                 sms: int = H100_SMS) -> dict:
    """How the s8 GEMM kernel (``csrc/gemm_i8.cu``) cuts ``[M, K] x [N, K] ->
    [M, N]`` with output mode ``out`` (one of :data:`GEMM_I8_OUTS`).

    The loop is the bf16 kernel's (:func:`gemm_bf16_plan`) with 128-byte
    depth boxes of int8: 128 rows of A8 by ``tile_n`` of W8, ``tile_k`` = 128
    values a stage. ``tile_n`` is 256 only without an activation, for the raw,
    bf16 and int8 outputs, where the wide tile pads N by at most 5 % more than
    the narrow one and still gives every SM a tile (the tower's qkv, proj and
    fc2, and 4096^3); everything else takes 128: the epilogues with an
    activation, the fp32 outputs and the small products of the Q-Former (M =
    1024 or 2048 rows, N = 768: 48 to 96 tiles of 128 x 256 would leave SMs
    idle). The kernel is built for exactly those combinations. bf16 and int8
    outputs leave through TMA stores where a row of Y has a 16-byte pitch
    (``y_tma``: N % 8 == 0 in bf16, N % 16 == 0 in int8; the kernel also
    needs a residual to be 16-byte aligned), the rest straight from the
    registers. Needs K % 16 == 0 (the 16-byte row pitch of TMA) and N % 2 ==
    0 (the epilogue's column pairs); raises ``ValueError`` on anything else.
    Cached: treat the result as read-only."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"gemm_i8: empty product M={M} N={N} K={K}")
    if K % 16 or N % 2:
        raise ValueError(f"gemm_i8: the kernel takes K % 16 == 0 (16-byte rows) and N % 2 == 0, "
                         f"got N={N} K={K}")
    if out not in GEMM_I8_OUTS:
        raise ValueError(f"gemm_i8: output mode one of {GEMM_I8_OUTS}, got {out!r}")
    if out == "s32" and act is not None:
        raise ValueError("gemm_i8: the raw int32 output takes no epilogue")
    if max(M * K, N * K, M * N) >= 2 ** 31:
        raise ValueError("gemm_i8: tensor too large for 32-bit indexing")
    wide, narrow = GEMM_TILES_N
    padded = {t: _ceil_div(N, t) * t for t in GEMM_TILES_N}
    tiles_m = _ceil_div(M, GEMM_TILE_M)
    tile_n = wide if (act is None and out != "f32"
                      and padded[wide] <= padded[narrow] * (1.0 + _WIDE_TILE_EXTRA_PADDING)
                      and tiles_m * _ceil_div(N, wide) >= sms) else narrow
    tiles_n = _ceil_div(N, tile_n)
    elt = {"s32": 4, "f32": 4, "bf16": 2, "s8": 1}[out]
    stage_bytes = GEMM_I8_TILE_K * (GEMM_TILE_M + tile_n)
    stages = 3 if tile_n == 256 else 5
    staging_bytes = 2 * GEMM_TILE_M * tile_n  # sized for bf16; int8 uses half of it
    smem = stages * stage_bytes + staging_bytes + 1024
    assert smem <= _SMEM_LIMIT
    y_tma = (out == "bf16" and N % 8 == 0) or (out == "s8" and N % 16 == 0)
    return {
        "tile_m": GEMM_TILE_M, "tile_n": tile_n, "tile_k": GEMM_I8_TILE_K,
        "tiles_m": tiles_m, "tiles_n": tiles_n, "tiles": tiles_m * tiles_n,
        "grid": min(tiles_m * tiles_n, sms),
        "k_steps": _ceil_div(K, GEMM_I8_TILE_K), "stages": stages,
        "stage_bytes": stage_bytes, "staging_bytes": staging_bytes, "smem_bytes": smem,
        "a_map": {"dims": (K, M), "pitch": K, "box": (GEMM_I8_TILE_K, GEMM_TILE_M)},
        "w_map": {"dims": (K, N), "pitch": K, "box": (GEMM_I8_TILE_K, tile_n)},
        "y_tma": y_tma,
        "y_map": {"dims": (N, M), "pitch": elt * N, "box": (128 // elt, 64)} if y_tma else None,
        "last_rows": M - (tiles_m - 1) * GEMM_TILE_M,
        "last_cols": N - (tiles_n - 1) * tile_n,
        "last_depth": K - (_ceil_div(K, GEMM_I8_TILE_K) - 1) * GEMM_I8_TILE_K,
        "padding": tiles_m * GEMM_TILE_M * tiles_n * tile_n / (M * N) - 1.0,
    }


# --------------------------------------------------------------- fp32 GEMM

GEMM_F32_TILE_K = 32     # depth of one cp.async stage: 32 floats, eight 16-byte copies a row
GEMM_F32_PITCH = GEMM_F32_TILE_K + 4  # floats between rows in shared memory
GEMM_F32_STAGES = 4
# (rows, columns) of a block tile -> the kernel's rate per output on one SM,
# relative to the 128 x 128 tile's: 256 threads as 16 x 16, each with (rows /
# 16) x (columns / 16) outputs. Measured on an H100 at the Q-Former's k/v
# products (M = 8224 and 16448: 40.0 and 37.3 TFLOP/s; cli/kernel_sweep). A
# 128 x 96 tile ran at 36.7 and never beat 64 x 96 at one wave's cost.
GEMM_F32_TILES = {(128, 128): 1.0, (64, 96): 0.93}


def gemm_f32_cost(M: int, N: int, tile: tuple, sms: int = H100_SMS) -> float:
    """The plan's model of a product's time, in units of one 128 x 128 tile
    on one SM: one block per SM (``__launch_bounds__(256, 1)``), so the
    busiest SM runs ``ceil(tiles / sms)`` tiles one after another, each at
    its tile's rate."""
    bm, bn = tile
    tiles = _ceil_div(M, bm) * _ceil_div(N, bn)
    return _ceil_div(tiles, sms) * bm * bn / (128 * 128 * GEMM_F32_TILES[tile])


@functools.lru_cache(maxsize=256)
def gemm_f32_plan(M: int, N: int, K: int, sms: int = H100_SMS) -> dict:
    """How the true-fp32 GEMM kernel (``csrc/gemm.cu``, CUDA-core FMA) cuts
    ``[M, K] x [N, K] -> [M, N]``: the block tile of :data:`GEMM_F32_TILES`
    with the least :func:`gemm_f32_cost` (ties to the larger tile), one block
    per tile (``grid`` = (column tiles, row tiles)), a ring of
    ``stages`` cp.async stages of ``tile_k`` floats. The Q-Former's products
    at N = 768 take 64 x 96 (M = 1024: 128 tiles, one wave; M = 2048: two
    waves), the image's k/v products (M = 8224 or 16448) and fc1 (N = 3072, M
    = 2048) 128 x 128. A row is read as 16-byte
    copies: K % 4 == 0. Raises ``ValueError`` on anything else. Cached: treat
    the result as read-only."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"gemm: empty product M={M} N={N} K={K}")
    if K % 4:
        raise ValueError(f"gemm: the fp32 kernel reads 16-byte rows: K % 4 == 0, got K={K}")
    if max(M * K, N * K, M * N) >= 2 ** 31:
        raise ValueError("gemm: tensor too large for 32-bit indexing")
    tm, tn = min(GEMM_F32_TILES, key=lambda t: (gemm_f32_cost(M, N, t, sms), -t[0] * t[1]))
    tiles_m, tiles_n = _ceil_div(M, tm), _ceil_div(N, tn)
    stage_bytes = 4 * GEMM_F32_PITCH * (tm + tn)
    return {
        "tile_m": tm, "tile_n": tn, "tile_k": GEMM_F32_TILE_K, "thread_tile": (tm // 16, tn // 16),
        "tiles_m": tiles_m, "tiles_n": tiles_n, "tiles": tiles_m * tiles_n,
        "grid": (tiles_n, tiles_m), "waves": _ceil_div(tiles_m * tiles_n, sms),
        "k_steps": _ceil_div(K, GEMM_F32_TILE_K), "stages": GEMM_F32_STAGES,
        "stage_bytes": stage_bytes, "smem_bytes": GEMM_F32_STAGES * stage_bytes,
        "last_rows": M - (tiles_m - 1) * tm, "last_cols": N - (tiles_n - 1) * tn,
        "last_depth": K - (_ceil_div(K, GEMM_F32_TILE_K) - 1) * GEMM_F32_TILE_K,
        "padding": tiles_m * tm * tiles_n * tn / (M * N) - 1.0,
    }


def gemm_f32_thread(tid: int) -> tuple:
    """(ty, tx) of thread ``tid`` of the fp32 kernel's 16 x 16 grid: a warp
    is 4 rows of 8 (ty = 4 (warp / 2) + lane / 8, tx = 8 (warp % 2) + lane %
    8). The thread owns tile rows ty + 16 i and columns tx + 16 j."""
    warp, lane = divmod(tid, 32)
    return (warp // 2) * 4 + lane // 8, (warp % 2) * 8 + lane % 8


def gemm_f32_tiles(plan: dict) -> list:
    """(first row, first column) of every block tile, in launch order."""
    return [(by * plan["tile_m"], bx * plan["tile_n"])
            for by in range(plan["tiles_m"]) for bx in range(plan["tiles_n"])]


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
