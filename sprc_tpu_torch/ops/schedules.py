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
``attention_plain`` and against the JAX package. The same holds for the fp32
attention, the LayerNorm, the quantisers and K1 (:func:`token_max_sim_plan`,
:func:`token_max_sim_emulated`).
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


GRID_YZ_MAX = 65535  # the largest gridDim.y and gridDim.z CUDA launches


def _int32_dims(name: str, M: int, N: int, K: int) -> None:
    """The fp32 and s8 GEMMs' C entries take M, N and K as 32-bit ints and
    form every element offset in 64 bits (``(size_t)row * N + col``, TMA
    coordinates per row and column), so a product may hold more than 2^31
    elements; each of M, N and K must fit an int."""
    if max(M, N, K) > 2 ** 31 - 1:
        raise ValueError(f"{name}: M={M} N={N} K={K}; the C entry takes each as a 32-bit int")


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
    0 (the epilogue's column pairs); a product may hold 2^31 elements or
    more (:func:`_int32_dims`); raises ``ValueError`` on anything else.
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
    _int32_dims("gemm_i8", M, N, K)
    wide, narrow = GEMM_TILES_N
    padded = {t: _ceil_div(N, t) * t for t in GEMM_TILES_N}
    tiles_m = _ceil_div(M, GEMM_TILE_M)
    tile_n = wide if (act is None and out != "f32"
                      and padded[wide] <= padded[narrow] * (1.0 + _WIDE_TILE_EXTRA_PADDING)
                      and tiles_m * _ceil_div(N, wide) >= sms) else narrow
    tiles_n = _ceil_div(N, tile_n)
    if tiles_m * tiles_n > 2 ** 31 - 1:
        raise ValueError(f"gemm_i8: {tiles_m} x {tiles_n} tiles; the kernel counts them in an int")
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
    copies: K % 4 == 0. A product may hold 2^31 elements or more
    (:func:`_int32_dims`; the rerank's cross key / value products on EVA
    ViT-g: M = 3000 x 514, K = 1408) as long as its row tiles fit gridDim.y.
    Raises ``ValueError`` on anything else. Cached: treat the result as
    read-only."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"gemm: empty product M={M} N={N} K={K}")
    if K % 4:
        raise ValueError(f"gemm: the fp32 kernel reads 16-byte rows: K % 4 == 0, got K={K}")
    _int32_dims("gemm", M, N, K)
    tm, tn = min(GEMM_F32_TILES, key=lambda t: (gemm_f32_cost(M, N, t, sms), -t[0] * t[1]))
    tiles_m, tiles_n = _ceil_div(M, tm), _ceil_div(N, tn)
    if tiles_m > GRID_YZ_MAX:
        raise ValueError(f"gemm: M={M} gives {tiles_m} row tiles of {tm}; the fp32 kernel's "
                         f"grid takes at most {GRID_YZ_MAX} in gridDim.y")
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


# ----------------------------------------------------------- fp32 attention

ATTN_F32_KEY_CHUNK = 32      # keys of one shared-memory stage
ATTN_F32_MAX_WARPS = 8       # warps of a block, 16 query rows each
ATTN_F32_TILE = 8            # keys of a score tile, of a P V k-step; dims of an output tile


def tf32_round(x: Tensor) -> Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, the low 13 bits of the mantissa cleared (done on the bits:
    half of the dropped unit added to the magnitude, then masked)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: Tensor) -> tuple:
    """(big, small): big = TF32(x), small = TF32(x - big), the kernel's
    ``split_tf32``; x - big is exact in fp32."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def mma_3xtf32(acc: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``acc + a @ b`` as the kernel's ``mma_3xtf32`` takes it over one
    k-step of 8 (a [..., M, 8], b [..., 8, N]): small . big, big . small,
    big . big, three ``mma.m16n8k8`` that each add the exact sum of their 8
    products to the fp32 accumulator with one rounding (taken here in
    float64, then rounded)."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
        acc = (acc.double() + x.double() @ y.double()).float()
    return acc


def attention_f32_warps(Sq: int) -> int:
    """Warps of a block of the fp32 attention kernel for ``Sq`` query rows:
    all of a head's rows up to 4 warp tiles of 16 (one block a head reads K
    and V once), else the fewest blocks of at most 8 warps with the warp
    tiles spread evenly (S = 257: 3 blocks of 6 warps, 96 rows).
    ``csrc/attention.cu::f32_warps`` is the same rule."""
    tiles = _ceil_div(Sq, ATTN_WARP_ROWS)
    if tiles <= 4:
        return tiles
    blocks = _ceil_div(tiles, ATTN_F32_MAX_WARPS)
    return _ceil_div(tiles, blocks)


def check_attention_grid(B: int, H: int) -> None:
    """Both attention paths launch the grid ``(blocks, H, B)``: a batch of
    more than :data:`GRID_YZ_MAX` items (a rerank tile of ``step x top``
    candidates) or heads is refused here, not launched wrongly."""
    if B > GRID_YZ_MAX or H > GRID_YZ_MAX:
        raise ValueError(f"attention: B={B} H={H}; the kernel's grid takes at most "
                         f"{GRID_YZ_MAX} of each (gridDim.z, gridDim.y)")


def attention_f32_plan(Sq: int, Sk: int, D: int, B: int = 1, H: int = 1) -> dict:
    """How the fp32 attention kernel of ``csrc/attention.cu`` (3xTF32 on
    ``mma.sync.m16n8k8``) cuts an ``Sq x Sk`` head at head dim ``D`` (``D %
    8 == 0``; the card builds 64 and 88): ``warps`` of 16 query rows a block
    (:func:`attention_f32_warps`), the grid ``(blocks, H, B)``, key chunks of
    32 through ``stages`` cp.async stages (one where there is one chunk),
    and per chunk the 8-key score tiles and P V k-steps that hold a valid
    key (the others are skipped). ``smem_bytes`` is one block's dynamic
    shared memory (Q, and per stage K, V and the column terms, rows pitched
    D + 4); ``blocks_per_sm`` what that memory and the 64 warps of an SM
    allow (the registers, 127 or 128 a thread as ``ptxas`` reads them, allow
    two blocks of 8 warps). Raises ``ValueError`` on an
    empty head or a head dim the mma tiles cannot take."""
    if Sq < 1 or Sk < 1:
        raise ValueError(f"attention: needs at least one query and one key, got {Sq} x {Sk}")
    check_attention_grid(B, H)
    if D < ATTN_F32_TILE or D % ATTN_F32_TILE:
        raise ValueError(f"attention: the fp32 path takes D % 8 == 0, got {D}")
    warps = attention_f32_warps(Sq)
    rows = warps * ATTN_WARP_ROWS
    blocks = _ceil_div(Sq, rows)
    chunks = []
    for c0 in range(0, Sk, ATTN_F32_KEY_CHUNK):
        kv = min(ATTN_F32_KEY_CHUNK, Sk - c0)
        chunks.append({"first_key": c0, "valid": kv, "tiles": _ceil_div(kv, ATTN_F32_TILE)})
    stages = 2 if len(chunks) > 1 else 1
    ld = D + 4
    smem = 4 * (rows * ld + stages * (2 * ATTN_F32_KEY_CHUNK * ld + ATTN_F32_KEY_CHUNK))
    per_sm = min(_SMEM_LIMIT // smem, 64 // warps)
    warp_tiles = _ceil_div(Sq, ATTN_WARP_ROWS)
    keys = sum(c["tiles"] for c in chunks) * ATTN_F32_TILE
    return {"warps": warps, "block_rows": rows, "blocks": blocks, "grid": (blocks, H, B),
            "warp_tiles": warp_tiles, "chunks": chunks, "stages": stages,
            "smem_bytes": smem, "blocks_per_sm": per_sm,
            # computed over useful products (warps whose rows all lie past Sq skip)
            "padding": warp_tiles * ATTN_WARP_ROWS * keys / (Sq * Sk) - 1.0}


def attention_f32_emulated(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                           col_bias: Optional[Tensor] = None) -> Tensor:
    """``attention_plain``'s function in fp32 computed the way the fp32
    kernel of ``csrc/attention.cu`` walks it (a query row's arithmetic does
    not depend on its block or warp, so all rows go at once): key chunks of
    32 in order; per chunk the 8-key score tiles with a valid key, each the
    3xTF32 product (:func:`mma_3xtf32`) over the depth steps of 8 in order;
    ``s = (q . k) * scale + bias`` with two roundings, keys past Sk at -inf;
    the running max ``m``; ``corr = exp(m_old - m)``; ``p = exp(s - m)``; the
    row sum as the kernel takes it (each of the 4 lanes of a row's quad sums
    its keys 8 j + 2t, 8 j + 2t + 1 in order, then two xor shuffles); ``l =
    l * corr + rowsum`` and ``o = o * corr + pv``, each step rounded on its
    own, where ``pv`` is the chunk's unnormalised P V in 3xTF32 over its
    tiles in order, from zero; ``o / l`` last.
    q [B, Sq, H*D], k/v [B, Sk, H*D], col_bias [B, Sk] -> [B, Sq, H*D] fp32."""
    B, Sq, W = q.shape
    Sk = k.shape[1]
    D = W // heads
    plan = attention_f32_plan(Sq, Sk, D)
    f32, T = torch.float32, ATTN_F32_TILE

    def heads_of(t):  # [B, S, H*D] -> [B, H, S, D]
        return t.to(f32).reshape(B, t.shape[1], heads, D).permute(0, 2, 1, 3)

    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    keys_p = len(plan["chunks"]) * ATTN_F32_KEY_CHUNK
    add = torch.full((B, keys_p), -math.inf, dtype=f32)
    add[:, :Sk] = 0.0 if col_bias is None else col_bias.to(f32)
    scale32 = torch.tensor(scale, dtype=f32)
    quad = torch.arange(4)
    m = torch.full((B, heads, Sq, 1), -math.inf, dtype=f32)
    l = torch.zeros_like(m)
    o = torch.zeros(B, heads, Sq, D, dtype=f32)
    for ch in plan["chunks"]:
        c0, kv, tiles = ch["first_key"], ch["valid"], ch["tiles"]
        cols = tiles * T  # key columns computed; past kv they are zeros, then masked
        kc = torch.zeros(B, heads, cols, D, dtype=f32)
        vc = torch.zeros(B, heads, cols, D, dtype=f32)
        kc[:, :, :kv], vc[:, :, :kv] = kh[:, :, c0:c0 + kv], vh[:, :, c0:c0 + kv]
        s = torch.zeros(B, heads, Sq, cols, dtype=f32)
        for kk in range(0, D, T):
            s = mma_3xtf32(s, qh[..., kk:kk + T], kc[..., kk:kk + T].transpose(-1, -2))
        s = s * scale32 + add[:, None, None, c0:c0 + cols]
        m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        pair = p.reshape(B, heads, Sq, tiles, 4, 2)  # [.., tile j, lane t, key 2t + e]
        part = torch.zeros(B, heads, Sq, 4, dtype=f32)
        for j in range(tiles):
            part = part + pair[..., j, :, 0]
            part = part + pair[..., j, :, 1]
        for x in (1, 2):
            part = part + part[..., quad ^ x]
        l = l * corr + part[..., :1]
        pv = torch.zeros_like(o)
        for j in range(0, cols, T):
            pv = mma_3xtf32(pv, p[..., j:j + T], vc[:, :, j:j + T])
        o = o * corr + pv
        m = m_new
    out = o / l
    return out.permute(0, 2, 1, 3).reshape(B, Sq, W)


# ---------------------------------------------------------------- LayerNorm

LN_WIDTHS = (768, 1024, 1408)  # the widths built as template parameters
LN_MAX_W = 4096              # the generic instantiation's largest row


def _warp_row_plan(name: str, W: int, elt: int, aligned: bool, widths: tuple, max_w: int) -> dict:
    """How a warp-a-row kernel (``csrc/layernorm.cu``, ``csrc/quantize.cu``'s
    rows kernel) reads a row of ``W`` elements of ``elt`` bytes, given the
    widths it is built for as template parameters and its widest row."""
    if not 1 <= W <= max_w:
        raise ValueError(f"{name}: rows of 1 to {max_w} elements, got {W}")
    if elt not in (2, 4):
        raise ValueError(f"{name}: bf16 or fp32 rows, got {elt}-byte elements")
    per16 = 16 // elt
    vec = per16 if aligned and W % per16 == 0 else 1
    step = 32 * vec
    loads = _ceil_div(W, step)
    width = W if vec > 1 and W in widths else "generic"
    compiled = _ceil_div(W if width != "generic" else max_w, step)
    return {"vec": vec, "width": width, "step": step, "loads": loads,
            "registers": compiled * vec, "tail_lanes": _ceil_div(W - (loads - 1) * step, vec),
            "values_per_lane": W / 32}


def _warp_row_lanes(plan: dict, W: int) -> Tensor:
    vec, step = plan["vec"], plan["step"]
    lane = torch.arange(32)[:, None, None]
    c = torch.arange(plan["loads"])[None, :, None]
    e = torch.arange(vec)[None, None, :]
    idx = (c * step + lane * vec + e).reshape(32, -1)
    return torch.where(idx < W, idx, torch.full_like(idx, -1))


def layer_norm_plan(W: int, elt: int, aligned: bool = True) -> dict:
    """How ``csrc/layernorm.cu`` reads a row of ``W`` elements of ``elt``
    bytes: ``vec`` elements a lane loads at once (16 bytes where the row is
    a whole number of 16-byte loads and the data is aligned, else 1), the
    instantiation (``width``: a main-path width, or ``"generic"`` for every
    other W <= 4096), ``loads`` a lane makes (the last one masked on the
    lanes past the row's end: ``tail_lanes`` of them take part), ``registers``
    the fp32 values a lane holds, and ``values_per_lane`` W / 32."""
    return _warp_row_plan("layer_norm", W, elt, aligned, LN_WIDTHS, LN_MAX_W)


def layer_norm_lanes(W: int, elt: int, aligned: bool = True) -> Tensor:
    """[32, loads * vec] element index per lane in the order the lane sums
    them (-1 past the row's end)."""
    return _warp_row_lanes(layer_norm_plan(W, elt, aligned), W)


def _warp_sum(part: Tensor) -> Tensor:
    """The xor butterfly of ``sprc::warp_sum`` over the last axis (32 lanes):
    every lane ends with the same sum."""
    lane = torch.arange(32)
    for x in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ x]
    return part[..., 0]


def layer_norm_emulated(x: Tensor, w: Tensor, b: Tensor, eps: float,
                        residual: Optional[Tensor] = None,
                        out_scale: Optional[float] = None) -> Tensor:
    """``layer_norm_plain``'s function computed as the LayerNorm kernel
    walks a row: ``v = x + r`` in fp32; each lane sums its elements in load
    order (:func:`layer_norm_lanes`), the lanes meet in the butterfly; the
    mean is that sum / W; the variance the same walk over ``(v - mean)^2``
    (each square rounded) / W; ``y = ((v - mean) * rsqrt(var + eps)) * w +
    b``, every step rounded; rounded to ``x.dtype``, or with ``out_scale``
    the int8 codes ``clip(rint(y * (1 / out_scale)))``."""
    W = x.shape[-1]
    v = x.float().reshape(-1, W)
    if residual is not None:
        v = v + residual.float().reshape(-1, W)
    idx = layer_norm_lanes(W, x.element_size())
    valid = idx >= 0
    vals = torch.where(valid, v[:, idx.clamp(min=0)], torch.zeros((), dtype=torch.float32))
    part = torch.zeros(v.shape[0], 32, dtype=torch.float32)
    for j in range(idx.shape[1]):
        part = part + vals[:, :, j]
    mean = (_warp_sum(part) / W)[:, None]
    d = torch.where(valid, vals - mean[:, :, None], torch.zeros((), dtype=torch.float32))
    sq = d * d
    part = torch.zeros_like(part)
    for j in range(idx.shape[1]):
        part = part + sq[:, :, j]
    var = (_warp_sum(part) / W)[:, None]
    rstd = torch.rsqrt(var + eps)
    y = ((v - mean) * rstd * w.float() + b.float()).reshape(x.shape)
    if out_scale is not None:
        return torch.clamp(torch.round(y * (1.0 / out_scale)), -127, 127).to(torch.int8)
    return y.to(x.dtype)


# --------------------------------------------------------------- quantizers

QUANT_WIDTHS = (768, 1024, 1408, 3072)  # quantize_rows' widths built as template parameters
QUANT_MAX_W = 4096                     # the widest row quantize_rows takes
QUANT_ROWS_WARPS = 4                   # rows (warps) a block of quantize_rows
QUANT_STATIC_THREADS = 256             # threads a block of quantize_static
QUANT_STATIC_UNROLL = 4                # 16-byte loads a thread of it has in flight
QUANT_STATIC_BLOCKS_PER_SM = 4         # its blocks an SM, all resident


def quantize_static_plan(n: int, elt: int, aligned: bool = True, sms: int = H100_SMS,
                         blocks_per_sm: int = QUANT_STATIC_BLOCKS_PER_SM) -> dict:
    """How ``csrc/quantize.cu`` streams ``n`` values of ``elt`` bytes through
    ``quantize_static``: ``vec`` values a load (16 bytes where ``n`` is a
    whole number of 16-byte loads and input and output are aligned, else 1),
    ``loads`` in all, ``threads`` a block, ``unroll`` loads a thread issues
    before it uses one, ``blocks`` (``sms`` x ``blocks_per_sm``, all resident
    at once; fewer where the tensor is smaller) and ``steps`` of a thread's
    loop, the last one masked."""
    if elt not in (2, 4):
        raise ValueError(f"quantize_static: bf16 or fp32 values, got {elt}-byte elements")
    per16 = 16 // elt
    vec = per16 if aligned and n % per16 == 0 else 1
    loads = n // vec
    per_block = QUANT_STATIC_THREADS * QUANT_STATIC_UNROLL
    blocks = min(_ceil_div(loads, per_block), sms * blocks_per_sm)
    return {"vec": vec, "loads": loads, "threads": QUANT_STATIC_THREADS,
            "unroll": QUANT_STATIC_UNROLL, "blocks": blocks,
            "steps": _ceil_div(loads, blocks * per_block) if blocks else 0}


def quantize_static_loads(n: int, elt: int, aligned: bool = True, **kw) -> Tensor:
    """[threads of the grid, steps x unroll, vec]: the element index each
    thread of :func:`quantize_static_plan` converts, in its order (-1 where
    its load is masked)."""
    plan = quantize_static_plan(n, elt, aligned, **kw)
    T = plan["blocks"] * plan["threads"]
    t = torch.arange(T)[:, None, None]
    k = torch.arange(plan["steps"] * plan["unroll"])[None, :, None]
    e = torch.arange(plan["vec"])[None, None, :]
    load = t + k * T  # the thread's u-th load of step s is t + (s * unroll + u) * T
    idx = (load * plan["vec"] + e).reshape(T, -1)
    return torch.where((load < plan["loads"]).expand(-1, -1, plan["vec"]).reshape(T, -1), idx,
                       torch.full_like(idx, -1))


def quantize_rows_plan(W: int, elt: int, aligned: bool = True, rows: int = 1) -> dict:
    """How ``csrc/quantize.cu`` reads a row for ``quantize_rows``: the keys of
    :func:`layer_norm_plan` (the same warp-a-row walk, built for
    :data:`QUANT_WIDTHS`), ``rows_per_block`` and the ``blocks`` of a call
    over ``rows`` rows."""
    plan = _warp_row_plan("quantize_rows", W, elt, aligned, QUANT_WIDTHS, QUANT_MAX_W)
    return {**plan, "rows_per_block": QUANT_ROWS_WARPS,
            "blocks": _ceil_div(rows, QUANT_ROWS_WARPS)}


def quantize_rows_emulated(x: Tensor) -> tuple:
    """``quant.quantize_rows``'s function computed as the kernel walks a
    row: each lane takes the |max| of its loads (:func:`quantize_rows_plan`,
    16-byte chunks, the tail masked), the 32 lane maxima meet in the xor
    butterfly of ``sprc::warp_max``, ``sc = max(amax, 1e-8) * f32(1 / 127)``,
    and each value's code is ``clip(rint(x / sc))`` from the same lane's
    chunk. x [.., W] -> (int8 [.., W], sc [..])."""
    W = x.shape[-1]
    v = x.float().reshape(-1, W)
    idx = _warp_row_lanes(quantize_rows_plan(W, x.element_size()), W)
    valid = idx >= 0
    vals = torch.where(valid, v[:, idx.clamp(min=0)], torch.zeros((), dtype=torch.float32))
    part = vals.abs().amax(-1)  # [rows, 32]: each lane's |max| (0 on a masked load)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = torch.maximum(part, part[:, lane ^ o])
    sc = part[:, :1].clamp_min(1e-8) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    codes = torch.clamp(torch.round(vals / sc[:, :, None]), -127, 127).to(torch.int8)
    out = torch.zeros_like(v, dtype=torch.int8)
    out[:, idx[valid]] = codes[:, valid]
    return out.reshape(x.shape), sc.reshape(x.shape[:-1])


# ------------------------------------------------------ token-max similarity

SIM_TILE_B = 32            # query rows of a block: two m16 tiles
SIM_MAX_Q = 32             # tokens of an item: four n8 tiles
SIM_MAX_E = 512
SIM_KSTEPS_PER_WARP = 4    # k-steps of 8 a warp owns (its A fragments stay in registers)
SIM_MAX_STAGES = 4
SIM_BARRIER_BYTES = 64
SIM_RED_BYTES = 4 * 2 * 32 * 16  # one warp's partial sums: 4 (m tile, row half) x 2 float4 a lane
SMEM_RESERVED = 1024       # held back for each resident block
SMEM_SM = _SMEM_LIMIT + SMEM_RESERVED  # shared memory of an SM
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=256)
def token_max_sim_plan(B: int, N: int, Q: int, E: int, sms: int = H100_SMS) -> dict:
    """How ``csrc/token_max_sim.cu`` (its ``make_plan``) cuts ``out[b, n] =
    max_q <f[b], t[n, q]>``: ``warps`` (k-steps of 8 in runs of 4 a warp:
    E / 32 warps, at most 16), rows of a ring slot pitched ``pitch`` floats
    (E rounded up to 8 mod 16, so that a warp's float2 fragment reads hit 32
    banks, and at least E + 4 where E % 8 == 4) and rounded up to whole n8
    tiles (``slot_rows``); a slot holds an item, then (once every warp has
    read it) the warps' partial sums; ``stages`` slots (as many as fit, at
    most 4), two blocks an SM where that leaves at least two stages and the
    block has at most 8 warps (at the 128 registers a thread that its launch
    bounds allow, two such blocks fit), else one; ``tiles`` query tiles of
    32 rows, ``mtiles`` m16 tiles built in each (1 where B <= 16);
    ``groups`` of items (a block takes items ``group, group + groups, ...``),
    as many as the resident blocks allow, ``grid`` = groups x tiles (the
    tiles of a group neighbours). Raises ``ValueError`` on what the kernel
    does not take: Q > 32, E > 512, E % 4, an empty input, or B or N past
    the C entry's 32-bit ints. The gallery's size is no limit: offsets are
    64-bit. The result is cached (the wrapper consults it on every call):
    treat it as read-only."""
    if B < 1 or N < 1 or not 1 <= Q <= SIM_MAX_Q or not 4 <= E <= SIM_MAX_E or E % 4:
        raise ValueError(f"token_max_sim: B={B} N={N} Q={Q} E={E}; the kernel takes B, N >= 1, "
                         "Q <= 32, E <= 512, E % 4 == 0")
    if B > _INT32_MAX or N > _INT32_MAX:
        raise ValueError(f"token_max_sim: B={B} N={N}; the C entry takes B and N as 32-bit ints")
    ksteps = _ceil_div(E, 8)
    warps = _ceil_div(ksteps, SIM_KSTEPS_PER_WARP)
    pitch = E + (8 - E % 16) % 16
    rows = _ceil_div(Q, 8) * 8
    stage = max(rows * pitch * 4, warps * SIM_RED_BYTES)  # an item, then its partial sums
    fixed = SIM_BARRIER_BYTES

    def stages_for(bps):
        return min(SIM_MAX_STAGES, (SMEM_SM // bps - SMEM_RESERVED - fixed) // stage)

    bps = 2 if warps <= 8 and stages_for(2) >= 2 else 1
    stages = stages_for(bps)
    tiles = _ceil_div(B, SIM_TILE_B)
    groups = max(1, min(N, max(sms, 1) * bps // tiles))
    return {"warps": warps, "threads": 32 * warps, "ksteps": ksteps, "pitch": pitch,
            "slot_rows": rows, "stages": stages, "blocks_per_sm": bps, "tiles": tiles,
            "mtiles": 1 if B <= 16 else 2,
            "groups": groups, "grid": groups * tiles, "smem_bytes": fixed + stages * stage,
            "stage_bytes": stage}


def token_max_sim_blocks(plan: dict, N: int) -> list:
    """Per block of the plan's grid, in block order: (query tile, its items
    in the order it streams them)."""
    tiles, groups = plan["tiles"], plan["groups"]
    return [(blk % tiles, range(blk // tiles, N, groups)) for blk in range(plan["grid"])]


def split_tf32_trunc(x: Tensor) -> tuple:
    """(big, small) as ``split_tf32_trunc`` of ``csrc/tf32.cuh`` takes
    them: big = x with the low 13 bits of the mantissa cleared, small = the
    same of x - big (exact in fp32)."""
    def trunc(v):
        return (v.to(torch.float32).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    big = trunc(x)
    return big, trunc(x - big)


def _mma_3xtf32_parts(acc: Tensor, a: tuple, b: tuple) -> Tensor:
    """:func:`mma_3xtf32` on operands already split: small . big, big .
    small, big . big, each the exact sum of its 8 products added to ``acc``
    with one rounding."""
    (ab, as_), (bb, bs) = a, b
    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
        acc = (acc.double() + x.double() @ y.double()).float()
    return acc


def token_max_sim_emulated(feats: Tensor, targets: Tensor) -> Tensor:
    """``token_max_sim_plain``'s function computed as the kernel walks it:
    the depth zero-padded to whole k-steps of 8; each warp's partial sums
    over its k-steps in order, each step the 3xTF32 product from zero, the
    queries split by rounding (:func:`split_tf32`), the gallery's values by
    truncation (:func:`split_tf32_trunc`); the warps' partial sums added in
    warp order; the max over the item's Q tokens, NaN propagated as ``amax``
    does; a score that comes out NaN (a NaN or an infinity among its inputs:
    an infinity's small part is inf - inf) taken again as plain fp32 sums,
    as the kernel's ``exact_score`` does. (The kernel takes a k-step's 8
    depths in another order; the emulation sums them exactly, so the order
    does not show.) feats [B, E], targets [N, Q, E] -> [B, N] fp32."""
    B, E = feats.shape
    N, Q, _ = targets.shape
    plan = token_max_sim_plan(B, N, Q, E)
    kpad = plan["ksteps"] * 8 - E
    f = torch.nn.functional.pad(feats.float(), (0, kpad))
    t = torch.nn.functional.pad(targets.float(), (0, kpad))
    total = None
    for w in range(plan["warps"]):
        acc = torch.zeros(N, B, Q, dtype=torch.float32)
        for kk in range(w * SIM_KSTEPS_PER_WARP,
                        min((w + 1) * SIM_KSTEPS_PER_WARP, plan["ksteps"])):
            e = slice(8 * kk, 8 * kk + 8)
            acc = _mma_3xtf32_parts(acc, split_tf32(f[:, e]),
                                    split_tf32_trunc(t[:, :, e].transpose(1, 2)))
        total = acc if total is None else total + acc
    out = total.amax(-1).t().contiguous()
    b, n = torch.isnan(out).nonzero(as_tuple=True)
    out[b, n] = torch.einsum("ke,kqe->kq", feats[b].float(), targets[n].float()).amax(-1)
    return out
