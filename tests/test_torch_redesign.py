"""PyTorch port, the bucket-wide K1 and the warp-per-row K2 on the CPU (no
card needed): the host tables and schemes the kernels follow, held against
the port's references and the JAX package on the same inputs.

- K2 unwraps a row's posts one dependency level at a time
  (``floor.floor1_levels``); a plain unwrap in that order equals the serial
  ``floor1_unwrap_plain`` and JAX ``floor1_unwrap`` on every floor of the
  test groups and of the committed corpus's first chunk, and on drawn
  floor configurations.
- K2's rank kernel pops each row's mask bits and scans the rows in tiles
  with a carry; that scheme equals ``floor.ys_ranks``.
- K1 expands a bucket from one descriptor table
  (``residue_sym.bucket_table``); its twin, which walks that table, equals
  the per-submap ``expand_submap_plain`` results placed at their channels
  and JAX ``expand_submap``, formats 0 and 1 and residue 2 included.

Tolerances: none. Every step is integer arithmetic, and the residue sums
are sums of integers below 2^24, so all of it must match BIT FOR BIT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vorbispizza_tpu.ops.floor import floor1_unwrap
from vorbispizza_tpu.ops.residue_sym import expand_submap as jax_expand_submap
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.ops import floor, residue_sym
from vorbispizza_tpu_torch.testing.corpus32 import load_corpus
from vorbispizza_tpu_torch.testing.streams import make_streams

#: rows a tile of K2's rank kernel (csrc/floor1_synth.cu VP_RANK_THREADS)
RANK_TILE = 1024


def first_chunk(srcs):
    """(synth, sig, CPU tensors of the nine host arrays) of the first
    merged chunk decode_corpus forms from ``srcs`` (as f32)."""
    fronts, cost = [], 0
    for data in srcs:
        fronts.append(torch_corpus._front_end(data))
        cost += sum(b.batch_cost for b in fronts[-1][3])
        if cost >= VorbisConfig.default.corpus_batch_bytes:
            break
    synth = torch_corpus._synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    plan, buckets, _ = torch_corpus.merge_streams([f[2:4] for f in fronts])
    sig, host, _ = synth.prepare_host(plan, buckets, "f32")
    return synth, sig, [torch.from_numpy(a) for a in host]


_CHUNKS = {}


def chunk(group):
    if group not in _CHUNKS:
        srcs = load_corpus() if group == "corpus32" else make_streams(group)
        _CHUNKS[group] = first_chunk(srcs)
    return _CHUNKS[group]


def unwrap_by_levels(ys, tab, lev, P: int, multiplier: int):
    """Spec 7.2.2 step 2 in K2's order (plain form): each level's posts
    from a snapshot of the lower levels, in place over the coded values;
    step2 as ORs. -> (posts [G, P] int64 clamped, step2 [G, P] bool)."""
    xs, low_nb, high_nb = (v.tolist() for v in floor._split(tab, P)[:3])
    lev = lev.tolist()
    D = lev[0]
    start, order = lev[1 : D + 2], lev[D + 2 :]
    rng = floor.RANGES[multiplier - 1]
    val = ys.to(torch.int64).clone()
    s2 = torch.zeros(val.shape, dtype=torch.bool)
    s2[:, :2] = True
    for L in range(D):
        snap = val.clone()
        for i in order[start[L] : start[L + 1]]:
            lo, hi = low_nb[i], high_nb[i]
            y0, y1 = snap[:, lo], snap[:, hi]
            dy = y1 - y0
            off = torch.div(dy.abs() * (xs[i] - xs[lo]), xs[hi] - xs[lo],
                            rounding_mode="floor")
            pred = torch.where(dy < 0, y0 - off, y0 + off)
            v = snap[:, i]
            highroom, lowroom = rng - pred, pred
            room = 2 * torch.minimum(highroom, lowroom)
            big = torch.where(highroom > lowroom, v - lowroom + pred,
                              pred - v + highroom - 1)
            small = torch.where((v & 1) == 1, pred - ((v + 1) >> 1),
                                pred + (v >> 1))
            nz = v != 0
            val[:, i] = torch.where(nz, torch.where(v >= room, big, small),
                                    pred)
            for j in (i, lo, hi):
                s2[:, j] |= nz
    return val.clamp(0, rng - 1), s2


def check_levels(lev, tab, P):
    """Every post of a level reads only posts of lower levels, and every
    post 2..P-1 is on exactly one level."""
    _, low_nb, high_nb = (v.tolist() for v in floor._split(tab, P)[:3])
    lev = lev.tolist()
    D = lev[0]
    start, order = lev[1 : D + 2], lev[D + 2 :]
    assert start[0] == 0 and start[-1] == P - 2
    assert sorted(order) == list(range(2, P))
    level = {0: 0, 1: 0}
    for L in range(D):
        for i in order[start[L] : start[L + 1]]:
            level[i] = L + 1
    for i in range(2, P):
        assert level[low_nb[i]] < level[i] and level[high_nb[i]] < level[i]
    return D


def unwraps_agree(ys, xs, multiplier):
    """Level order, serial order and JAX on the same coded values."""
    P = len(xs)
    tab = torch.from_numpy(floor.floor1_tables(xs, 1))
    lev = torch.from_numpy(floor.floor1_levels(xs))
    D = check_levels(lev, tab, P)
    posts, step2 = unwrap_by_levels(ys, tab, lev, P, multiplier)
    sposts, sstep2 = floor.floor1_unwrap_plain(ys, tab, P, multiplier)
    jposts, jstep2 = floor1_unwrap(jnp.asarray(ys.numpy().astype(np.int32)),
                                   xs=tuple(xs), multiplier=multiplier)
    assert torch.equal(posts, sposts) and torch.equal(step2, sstep2)
    assert np.array_equal(posts.numpy(), np.asarray(jposts))
    assert np.array_equal(step2.numpy(), np.asarray(jstep2))
    return D


@pytest.mark.parametrize("group", ["stereo", "surround", "oddbooks",
                                   "corpus32"])
def test_floor1_levels_unwrap(group):
    """On every floor1 group of the chunk: the level table is a valid
    order, and unwrapping in it gives the serial order's and JAX's posts
    and step2 bits on the wire's own coded values."""
    synth, sig, bufs = chunk(group)
    depths = {}
    for bk in synth.buckets(sig, bufs):
        for ch, w, args in synth.floor_calls(bk):
            assert w == "ys"
            ys01, ysmask, ysnz, used, tab, ab, P, mult, half, lev = args
            meta = [m for m in bk["metas"] if list(m["channels"]) == ch][0]
            assert torch.equal(lev, torch.from_numpy(
                floor.floor1_levels(meta["xs"])))
            ys = floor.rebuild_ys(ys01, ysmask, ysnz, P)
            depths[P] = unwraps_agree(ys, list(meta["xs"]), mult)
    assert depths
    if group == "corpus32":
        # the floors the corpus's main path unwraps: fewer levels than
        # serial steps
        assert all(D < P - 2 for P, D in depths.items())


@st.composite
def floor_configs(draw):
    """A valid floor1 config: posts 0 and 1 at 0 and the range end, the
    other x distinct inside it, up to 65 posts; a multiplier; a seed for
    the coded values."""
    rangebits = draw(st.integers(7, 15))
    P = draw(st.integers(2, 65))
    inner = draw(st.lists(st.integers(1, (1 << rangebits) - 1), unique=True,
                          min_size=P - 2, max_size=P - 2))
    return [0, 1 << rangebits] + inner, draw(st.integers(1, 4)), draw(
        st.integers(0, 2**31 - 1))


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(floor_configs())
def test_floor1_levels_unwrap_drawn(cfg):
    """Drawn floor configs with random coded values (a third of them 0):
    level order equals serial order and JAX."""
    xs, multiplier, seed = cfg
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 256, size=(16, len(xs)))
    ys[rng.random(ys.shape) < 1 / 3] = 0
    unwraps_agree(torch.from_numpy(ys), xs, multiplier)


def ranks_tiled(mask: np.ndarray, P2: int, tile: int = RANK_TILE):
    """K2's rank kernel in plain form: each row's popcount of its bytes,
    the last byte masked to the P2 % 8 bits that belong to the row; an
    inclusive scan a tile at a time, minus the row's own count, plus the
    carry of the tiles before. -> int32 [G]."""
    G, mb = mask.shape
    last = (1 << (P2 % 8)) - 1 if P2 % 8 else 0xFF
    m = mask.copy()
    if mb:
        m[:, -1] &= last
    counts = np.unpackbits(m, axis=1).sum(axis=1).astype(np.int64)
    out = np.empty(G, dtype=np.int32)
    carry = 0
    for base in range(0, G, tile):
        c = counts[base : base + tile]
        out[base : base + tile] = carry + np.cumsum(c) - c
        carry += int(c.sum())
    return out


@pytest.mark.parametrize("G,P2", [(1, 1), (7, 8), (1023, 9), (1024, 27),
                                  (1025, 17), (6144, 63), (3000, 254)])
def test_rank_scheme_matches_ys_ranks(G, P2):
    """Random masks, with stray bits past P2 in each row's last byte (the
    kernel masks them off, as ys_ranks slices them off)."""
    rng = np.random.default_rng(G * 1000 + P2)
    mask = rng.integers(0, 256, size=(G, (P2 + 7) // 8), dtype=np.uint8)
    want = floor.ys_ranks(torch.from_numpy(mask), P2).numpy()
    assert np.array_equal(ranks_tiled(mask, P2), want)


def test_rank_scheme_on_the_corpus_wire():
    """The corpus chunk's own zero bitmasks."""
    synth, sig, bufs = chunk("corpus32")
    n = 0
    for bk in synth.buckets(sig, bufs):
        for _ch, _w, args in synth.floor_calls(bk):
            ys01, ysmask, P = args[0], args[1], args[6]
            G = ys01.numel() // 2
            mask = ysmask.reshape(G, -1)
            assert np.array_equal(ranks_tiled(mask.numpy(), P - 2),
                                  floor.ys_ranks(mask, P - 2).numpy())
            n += G
    assert n > 0


def test_ys_rebuild_from_ranks():
    """rebuild_ys (start rank + the set bits before a value) against the
    global-cumsum formulation of the reference's rebuild
    (pipeline.py:683-719) on the corpus chunk."""
    synth, sig, bufs = chunk("corpus32")
    for bk in synth.buckets(sig, bufs):
        for _ch, _w, args in synth.floor_calls(bk):
            ys01, ysmask, ysnz, P = args[0], args[1], args[2], args[6]
            G = ys01.numel() // 2
            bits = np.unpackbits(ysmask.numpy().reshape(G, -1), axis=1,
                                 bitorder="little")[:, : P - 2].reshape(-1)
            rank = np.cumsum(bits) - 1
            vals = ysnz.numpy()
            tail = np.where(bits > 0, vals[np.clip(rank, 0, len(vals) - 1)],
                            0).reshape(G, P - 2)
            want = np.concatenate([ys01.numpy().reshape(G, 2), tail], axis=1)
            got = floor.rebuild_ys(ys01, ysmask, ysnz, P).numpy()
            assert np.array_equal(got, want)


@pytest.mark.parametrize("group", ["stereo", "surround", "oddbooks", "floor0",
                                   "corpus32"])
def test_k1_bucket_twin(group):
    """The bucket twin (what K1's wrapper runs for CPU tensors, walking the
    descriptor table) equals the per-submap reference placed at each
    submap's channels, zeros elsewhere, and JAX expand_submap there."""
    synth, sig, bufs = chunk(group)
    n_groups = n_nonzero = 0
    fmts = set()
    for bk in synth.buckets(sig, bufs):
        table, ng, nb, wire, vq, shape = synth.residue_call(bk)
        got = residue_sym.expand_bucket(table, ng, nb, wire, vq, shape)
        assert torch.equal(got, residue_sym.expand_bucket_plain(
            table, ng, nb, wire, vq, shape))
        want = torch.zeros(shape)
        for ch, args in synth.residue_calls(bk):
            if args is None:
                continue
            sub_sig, syms, idx, vqs, Fp = args
            part = residue_sym.expand_submap_plain(*args)
            jpart = jax.jit(lambda s, x: jax_expand_submap(
                sub_sig, s, x, [v.numpy() for v in vqs], Fp))(
                [jnp.asarray(s.numpy()) for s in syms],
                [jnp.asarray(x.numpy()) for x in idx])
            assert np.array_equal(part.numpy(), np.asarray(jpart))
            want[:, ch] = part
            fmts |= {(int(g[3]), bool(sub_sig[5])) for g in sub_sig[7]}
        assert torch.equal(got, want)
        # one record a group that has threads; each starts on its own block
        first = table[: ng + 1].tolist()
        assert first[0] == 0 and first[-1] == nb
        assert all(b > a for a, b in zip(first, first[1:]))
        n_groups += ng
        n_nonzero += int(torch.count_nonzero(got))
    assert n_groups > 0 and n_nonzero > 0
    if group == "floor0":
        assert (0, False) in fmts  # format 0
    if group in ("stereo", "surround"):
        assert any(fmt2 for _, fmt2 in fmts)  # residue 2


def test_k1_table_is_cached_per_sig():
    """The table is made from the sig alone: the same sig gives the same
    tensor, sent to the device once."""
    synth, sig, bufs = chunk("stereo")
    a = synth.k1_tables(sig, "cpu")
    b = synth.k1_tables(sig, "cpu")
    assert a is b and all(x is y for x, y in zip(a, b))
