"""Floor curves: floor1 from either wire (kernel K2) and floor0 (K8).

Floor1 ports three stages of vorbispizza_tpu: the ys rebuild of
models/pipeline.py ``_fused_body`` (zero bitmask + compacted nonzero u8
stream -> coded values), ops/floor.py ``floor1_unwrap`` (spec 7.2.2
amplitude synthesis) and ops/floor.py ``floor1_curves`` (spec 9.2.6 line
render + inverse-dB lookup). Everything is integer arithmetic up to the
final ``A[v>>4] * B[v&15]`` float32 product, which the reference computes
the same way, so the port is bit-identical to it. The posts/step2 wire
(``floor1_from_posts``, K2's posts mode) skips the rebuild and the unwrap:
the host ships the unwrapped posts and the step2 bits.

Floor0 ports ops/floor.py ``floor0_curves`` (spec 6.2.3 LSP product, then
exp of the amplitude term), in the reference's order of float32
operations. Its cos/exp roundings differ between math libraries, so the
port agrees with the reference to ~1e-4 relative, not bit for bit; K8 and
its twin use the same operations in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build as K

#: floor1 range per multiplier (spec 7.2.2)
RANGES = (256, 128, 86, 64)

#: posts a K2 row can hold in shared memory (the spec allows 65), and
#: the widest curve (blocksize 8192) whose base-post table it shares
MAX_POSTS = 256
MAX_HALF = 4096


def inverse_db_tables() -> np.ndarray:
    """[32] float32: A[16] then B[16], with table[v] = A[v>>4] * B[v&15]
    (ops/floor.py floor1_curves)."""
    a = 10.0 ** (7.0 * 16.0 * np.arange(16, dtype=np.float64) / 256.0)
    b = 10.0 ** ((7.0 * np.arange(16, dtype=np.float64) - 7.0 * 255.0) / 256.0)
    return np.concatenate([a.astype(np.float32), b.astype(np.float32)])


def _neighbours(xs_np: np.ndarray):
    """low_nb, high_nb of spec 7.2.2: for post i >= 2 the earlier post with
    the largest x below x[i] and the one with the smallest x above it."""
    P = len(xs_np)
    low_nb = np.zeros(P, dtype=np.int64)
    high_nb = np.zeros(P, dtype=np.int64)
    for i in range(2, P):
        below = [j for j in range(i) if xs_np[j] < xs_np[i]]
        above = [j for j in range(i) if xs_np[j] > xs_np[i]]
        low_nb[i] = max(below, key=lambda j: xs_np[j])
        high_nb[i] = min(above, key=lambda j: xs_np[j])
    return low_nb, high_nb


def floor1_tables(xs, half: int) -> np.ndarray:
    """Static int32 tables of one floor1 config at one blocksize:
    xs[P] (config order) | low_nb[P] | high_nb[P] | order[P] (config index
    of each x-sorted post) | xs_s[P] (sorted x) | base_p[half] (largest
    sorted post with x <= bin)."""
    xs_np = np.asarray(xs, dtype=np.int64)
    low_nb, high_nb = _neighbours(xs_np)
    order = np.argsort(xs_np, kind="stable")
    xs_s = xs_np[order]
    base_p = np.searchsorted(xs_s, np.arange(half), side="right") - 1
    return np.concatenate([xs_np, low_nb, high_nb, order, xs_s, base_p]).astype(
        np.int32
    )


def floor1_levels(xs) -> np.ndarray:
    """Static int32 table of one floor1 config: the posts 2..P-1 grouped by
    their depth in the unwrap's dependency graph, depth(0) = depth(1) = 0
    and depth(i) = 1 + max(depth(low_nb[i]), depth(high_nb[i])). Layout:
    D (the number of levels) | start[D+1] (start[L] is where level L+1
    begins in the list, start[D] = P-2) | the posts, level by level, each
    level in ascending order. Every post of a level reads only posts of
    lower levels, so K2 unwraps a level's posts in parallel."""
    xs_np = np.asarray(xs, dtype=np.int64)
    P = len(xs_np)
    low_nb, high_nb = _neighbours(xs_np)
    depth = np.zeros(P, dtype=np.int64)
    for i in range(2, P):
        depth[i] = 1 + max(depth[low_nb[i]], depth[high_nb[i]])
    D = int(depth.max()) if P > 2 else 0
    posts = np.argsort(depth[2:], kind="stable") + 2
    counts = np.bincount(depth[2:], minlength=D + 1)[1:]
    starts = np.concatenate([[0], np.cumsum(counts)])
    return np.concatenate([[D], starts, posts]).astype(np.int32)


def _split(tab: torch.Tensor, P: int):
    t = tab.to(torch.int64)
    return (t[:P], t[P : 2 * P], t[2 * P : 3 * P], t[3 * P : 4 * P],
            t[4 * P : 5 * P], t[5 * P :])


def ys_ranks(ysmask: torch.Tensor, P2: int) -> torch.Tensor:
    """[G, B] packed zero bitmask of P2 values a row -> int64 [G]: each
    row's start rank in the compacted nonzero stream (exclusive prefix of
    per-row popcounts, row-major over the padded rows as the host compacts
    them). K2's rank kernel computes the same on the card."""
    shifts = torch.arange(8, device=ysmask.device, dtype=torch.int32)
    bits = (ysmask.to(torch.int32)[..., None] >> shifts) & 1
    counts = bits.reshape(ysmask.shape[0], -1)[:, :P2].sum(dim=1)
    return torch.cumsum(counts, 0) - counts


def rebuild_ys(ys01, ysmask, ysnz, P: int) -> torch.Tensor:
    """Coded values [G, P] int64 from the ys wire (pipeline.py ys rebuild):
    posts 0/1 raw, the rest zero or the next value of the nonzero stream."""
    ys01 = ys01.reshape(-1, 2).to(torch.int64)
    if P == 2:
        return ys01
    G = ys01.shape[0]
    P2 = P - 2
    mask = ysmask.reshape(G, -1)
    shifts = torch.arange(8, device=ys01.device, dtype=torch.int32)
    bits = (mask.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(G, -1)[:, :P2].to(torch.int64)
    # a value's index: its row's start rank, then the set bits before it
    rank = ys_ranks(mask, P2)[:, None] + torch.cumsum(bits, 1) - bits
    vals = ysnz.to(torch.int64)
    tail = torch.where(bits > 0, vals[rank.clamp(0, vals.shape[0] - 1)], 0)
    return torch.cat([ys01, tail], dim=1)


def floor1_unwrap_plain(ys: torch.Tensor, tab: torch.Tensor, P: int,
                        multiplier: int):
    """Spec 7.2.2 step 2 on [G, P] coded values -> (posts [G, P] int64
    clamped to the floor range, step2 [G, P] bool); ops/floor.py
    floor1_unwrap."""
    xs, low_nb, high_nb, _, _, _ = (v.tolist() for v in _split(tab, P))
    rng = RANGES[multiplier - 1]
    ysc = ys.to(torch.int64)
    true_col = torch.ones(ysc.shape[0], dtype=torch.bool, device=ys.device)
    final = [ysc[:, 0], ysc[:, 1]]
    step2 = [true_col, true_col] + [None] * (P - 2)
    for i in range(2, P):
        lo, hi = low_nb[i], high_nb[i]
        y0, y1 = final[lo], final[hi]
        dy = y1 - y0
        adx = xs[hi] - xs[lo]
        dx = xs[i] - xs[lo]
        off = torch.div(dy.abs() * dx, adx, rounding_mode="floor")
        predicted = torch.where(dy < 0, y0 - off, y0 + off)
        val = ysc[:, i]
        highroom = rng - predicted
        lowroom = predicted
        room = 2 * torch.minimum(highroom, lowroom)
        big = torch.where(
            highroom > lowroom,
            val - lowroom + predicted,
            predicted - val + highroom - 1,
        )
        small = torch.where(
            (val & 1) == 1, predicted - ((val + 1) >> 1), predicted + (val >> 1)
        )
        nz = val != 0
        final.append(torch.where(nz, torch.where(val >= room, big, small),
                                 predicted))
        step2[i] = nz
        step2[lo] = step2[lo] | nz
        step2[hi] = step2[hi] | nz
    posts = torch.stack(final, dim=1).clamp(0, rng - 1)
    return posts, torch.stack(step2, dim=1)


def floor1_curves_plain(posts, step2, used, tab: torch.Tensor, ab, P: int,
                        multiplier: int, half: int):
    """Piecewise-linear floor curves [G, half] float32 (ops/floor.py
    floor1_curves), with direct lookups in place of one-hot products."""
    _, _, _, order, xs_s, base_p = _split(tab, P)
    y_s = posts[:, order].to(torch.int64) * multiplier
    en_s = step2[:, order]
    G = posts.shape[0]
    idx = torch.arange(P, device=posts.device, dtype=torch.int64)
    # lo[p] = largest enabled q <= p ; hi[p] = smallest enabled q > p
    lo = torch.cummax(torch.where(en_s, idx, -1), dim=1).values
    rmin = torch.cummin(
        torch.where(en_s, idx, P).flip(1), dim=1
    ).values.flip(1)
    hi = torch.cat(
        [rmin[:, 1:], torch.full((G, 1), P, dtype=torch.int64,
                                 device=posts.device)], dim=1
    )
    lo_b = lo[:, base_p].clamp(min=0)
    hi_b = hi[:, base_p]
    has_hi = hi_b < P
    hi_c = torch.where(has_hi, hi_b, 0)
    x0 = xs_s[lo_b]
    x1 = torch.where(has_hi, xs_s[hi_c], x0)
    y0 = torch.gather(y_s, 1, lo_b)
    y1 = torch.gather(y_s, 1, hi_c)
    x = torch.arange(half, device=posts.device, dtype=torch.int64)[None, :]
    dy = y1 - y0
    adx = (x1 - x0).clamp(min=1)
    off = torch.div(dy.abs() * (x - x0), adx, rounding_mode="floor")
    val = torch.where(has_hi, y0 + torch.sign(dy) * off, y0).clamp(0, 255)
    curve = ab[val >> 4] * ab[16 + (val & 15)]
    return torch.where(used.reshape(-1, 1).bool(), curve, 0.0)


def floor1_from_ys_plain(ys01, ysmask, ysnz, used, tab, ab, P: int,
                         multiplier: int, half: int, lev):
    """Floor curves [G, half] float32 from the ys wire (plain twin of K2).
    It unwraps in the reference's serial order; ``lev``, the order K2
    takes, is not read (any order the dependencies allow gives the same
    posts)."""
    del lev
    ys = rebuild_ys(ys01, ysmask, ysnz, P)
    posts, step2 = floor1_unwrap_plain(ys, tab, P, multiplier)
    return floor1_curves_plain(posts, step2, used, tab, ab, P, multiplier,
                               half)


def step2_bits(step2: torch.Tensor, P: int) -> torch.Tensor:
    """[G, ceil(P/8)] LSB-first step2 bit planes -> bool [G, P]
    (pipeline.py posts/step2 wire)."""
    shifts = torch.arange(8, device=step2.device, dtype=torch.int32)
    bits = (step2.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(step2.shape[0], -1)[:, :P].bool()


def floor1_from_posts_plain(posts, step2, used, tab, ab, P: int,
                            multiplier: int, half: int):
    """Floor curves [G, half] float32 from the posts wire (plain twin of
    K2's posts mode): the shipped posts as they are, the step2 bits
    unpacked, then ``floor1_curves_plain``."""
    G = used.numel()
    return floor1_curves_plain(
        posts.reshape(G, P).to(torch.int64), step2_bits(step2.reshape(G, -1), P),
        used, tab, ab, P, multiplier, half)


def floor1_from_posts(posts, step2, used, tab, ab, P: int, multiplier: int,
                      half: int):
    """``floor1_from_posts_plain`` for CPU tensors; K2's posts mode for CUDA
    ones (counted as "floor1_posts").

    posts u8 [G, P]; step2 u8 [G, ceil(P/8)] (LSB-first over P); used u8
    [G]; ``tab`` from floor1_tables; ``ab`` from inverse_db_tables."""
    if posts.device.type == "cpu":
        return floor1_from_posts_plain(posts, step2, used, tab, ab, P,
                                       multiplier, half)
    if not 2 <= P <= MAX_POSTS or half > MAX_HALF:
        raise ValueError(f"floor1 with {P} posts over {half} bins (K2 holds "
                         f"2..{MAX_POSTS} posts, {MAX_HALF} bins)")
    G = used.numel()
    posts = posts.reshape(G, P)
    step2 = step2.reshape(G, (P + 7) // 8)
    used = used.reshape(G)
    K.require_cuda(posts, step2, used, tab, ab)
    if posts.dtype != torch.uint8 or step2.dtype != torch.uint8:
        raise TypeError("expected u8 posts and step2 bits")
    if tab.dtype != torch.int32 or ab.dtype != torch.float32:
        raise TypeError("expected int32 tables and float32 A/B")
    out = torch.empty((G, half), dtype=torch.float32, device=posts.device)
    if G:
        K.launch(
            "floor1_posts",
            posts.data_ptr(), step2.data_ptr(), used.data_ptr(),
            tab.data_ptr(), ab.data_ptr(), out.data_ptr(),
            G, P, half, multiplier,
        )
    return out


def floor1_from_ys(ys01, ysmask, ysnz, used, tab, ab, P: int,
                   multiplier: int, half: int, lev):
    """``floor1_from_ys_plain`` for CPU tensors; kernel K2 for CUDA ones
    (its C entry launches the rank kernel, then the main kernel; this
    wrapper only allocates the output and the rank scratch).

    ys01 u8 [G, 2]; ysmask u8 [G, ceil((P-2)/8)] and ysnz u8 [cap] (None
    when P == 2); used u8 [G]; ``tab`` from floor1_tables; ``ab`` from
    inverse_db_tables; ``lev`` from floor1_levels."""
    if ys01.device.type == "cpu":
        return floor1_from_ys_plain(ys01, ysmask, ysnz, used, tab, ab, P,
                                    multiplier, half, lev)
    if not 2 <= P <= MAX_POSTS or half > MAX_HALF:
        raise ValueError(f"floor1 with {P} posts over {half} bins (K2 holds "
                         f"2..{MAX_POSTS} posts, {MAX_HALF} bins)")
    G = ys01.numel() // 2
    cap = ysnz.numel() if P > 2 else 1
    if P == 2:
        ysmask = ysnz = ys01  # unread for P == 2
    K.require_cuda(ys01, ysmask, ysnz, used, tab, lev, ab)
    if (tab.dtype != torch.int32 or lev.dtype != torch.int32
            or ab.dtype != torch.float32):
        raise TypeError("expected int32 tables and float32 A/B")
    out = torch.empty((G, half), dtype=torch.float32, device=ys01.device)
    rank = torch.empty(G if P > 2 else 0, dtype=torch.int32,
                       device=ys01.device)
    if G:
        K.launch(
            "floor1_synth",
            ys01.data_ptr(), ysmask.data_ptr(), ysnz.data_ptr(),
            rank.data_ptr(), used.data_ptr(), tab.data_ptr(), lev.data_ptr(),
            ab.data_ptr(), out.data_ptr(),
            G, P, half, multiplier, RANGES[multiplier - 1], cap,
        )
    return out


#: floor0 orders K8 holds in shared memory (the 8-bit field allows 255)
MAX_ORDER = 255


def floor0_tables(bark_map, bark_map_size: int, order: int) -> np.ndarray:
    """Static float32 tables of one floor0 config at one blocksize, [3,
    half]: cos_w (made in float64, then cast, as ops/floor.py
    floor0_curves makes it), then the tail factors of p and of q: for an
    odd order 1 - cos_w^2 and 0.25, for an even one (1 - cos_w) * 0.5 and
    (1 + cos_w) * 0.5, in float32 as the reference's program computes
    them from cos_w."""
    m = np.asarray(bark_map, dtype=np.float64)
    cos_w = np.cos(np.pi * m / bark_map_size).astype(np.float32)
    one, half_ = np.float32(1.0), np.float32(0.5)
    if order % 2 == 1:
        tp = one - cos_w * cos_w
        tq = np.full_like(cos_w, np.float32(0.25))
    else:
        tp = (one - cos_w) * half_
        tq = (one + cos_w) * half_
    return np.stack([cos_w, tp, tq]).astype(np.float32)


def floor0_curves_plain(coefficients, amplitude, used, tab, order: int,
                        amplitude_bits: int, amplitude_offset: int):
    """LSP floor curves [G, half] float32 (plain twin of K8; ops/floor.py
    floor0_curves, the same float32 operations in the same order).

    coefficients f32 [G, order]; amplitude i32 [G]; used u8 [G]; ``tab``
    from floor0_tables."""
    f32 = torch.float32
    G = used.numel()
    cos_w, tail_p, tail_q = tab[0], tab[1], tab[2]
    cos_c = torch.cos(coefficients.reshape(G, order))
    p = torch.ones((G, cos_w.shape[0]), dtype=f32, device=cos_w.device)
    q = torch.ones_like(p)
    four = torch.tensor(4.0, dtype=f32, device=cos_w.device)
    for j in range(order):
        d = cos_c[:, j : j + 1] - cos_w[None, :]
        t = four * (d * d)
        if j % 2 == 1:
            p = p * t
        else:
            q = q * t
    p = p * tail_p[None, :]
    q = q * tail_q[None, :]
    denom = torch.sqrt(p + q)
    denom = torch.where(denom == 0.0, torch.tensor(1e-9, dtype=f32,
                                                    device=denom.device), denom)
    amp_max = torch.tensor(float((1 << amplitude_bits) - 1), dtype=f32,
                           device=denom.device)
    off = torch.tensor(float(amplitude_offset), dtype=f32, device=denom.device)
    amp = amplitude.reshape(G).to(f32)[:, None]
    exponent = torch.tensor(0.11512925, dtype=f32, device=denom.device) * (
        (amp * off) / (amp_max * denom) - off
    )
    linear = torch.exp(torch.minimum(
        exponent, torch.tensor(80.0, dtype=f32, device=denom.device)))
    return torch.where(used.reshape(G, 1).bool(), linear, 0.0)


def check_floor0_operands(tab, out) -> None:
    """K8 reads ``tab`` as one contiguous float32 [3, half] tensor (cos_w,
    then the tails of p and of q, ``half`` floats apart) and reads and
    writes float4s: refuse any other ``tab``, a ``half`` that is not a
    multiple of 4, and a ``tab`` or ``out`` off a 16-byte boundary."""
    if (tab.dtype != torch.float32 or tab.dim() != 2 or tab.shape[0] != 3
            or not tab.is_contiguous()):
        raise ValueError(
            "K8 takes tab as one contiguous float32 [3, half] tensor "
            f"(floor0_tables), got {tab.dtype} {tuple(tab.shape)} "
            f"with strides {tab.stride()}")
    if tab.shape[1] % 4 or tab.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("K8 reads and writes float4s: half must be a "
                         "multiple of 4 and tab and out 16-byte aligned")


def floor0_curves(coefficients, amplitude, used, tab, order: int,
                  amplitude_bits: int, amplitude_offset: int):
    """``floor0_curves_plain`` for CPU tensors; kernel K8 for CUDA ones
    (``check_floor0_operands`` says what it refuses)."""
    if used.device.type == "cpu":
        return floor0_curves_plain(coefficients, amplitude, used, tab, order,
                                   amplitude_bits, amplitude_offset)
    if not 1 <= order <= MAX_ORDER:
        raise ValueError(f"floor0 order {order} (K8 holds 1..{MAX_ORDER})")
    G = used.numel()
    half = tab.shape[-1]
    out = torch.empty((G, half), dtype=torch.float32, device=used.device)
    check_floor0_operands(tab, out)
    coefficients = coefficients.reshape(G, order)
    amplitude = amplitude.reshape(G)
    used = used.reshape(G)
    K.require_cuda(coefficients, amplitude, used, tab)
    if (coefficients.dtype != torch.float32 or amplitude.dtype != torch.int32
            or used.dtype != torch.uint8):
        raise TypeError("expected f32 coefficients, i32 amplitude and u8 "
                        "used")
    if G:
        K.launch(
            "floor0_synth",
            coefficients.data_ptr(), amplitude.data_ptr(), used.data_ptr(),
            tab.data_ptr(), out.data_ptr(),
            G, order, half,
            float(np.float32((1 << amplitude_bits) - 1)),
            float(np.float32(amplitude_offset)),
        )
    return out
