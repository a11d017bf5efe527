"""Vorbis floors: Floor0 (LSP) and Floor1 (piecewise line).

Config parse + per-packet unpack + host-side (numpy) curve synthesis.
Behavior parity with reference NVorbis/Floor0.cs:9 and NVorbis/Floor1.cs:13;
implemented from Vorbis I spec sections 6 (floor0) and 7 (floor1).

The per-packet unpack results are plain dataclasses so the TPU batch front
end (frames.py) can collect them into dense tensors; synthesis here is the
scalar correctness anchor that ops/ kernels are verified against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream import BitReader
from ..errors import InvalidDataError
from ..utils.bits import ilog
from .codebook import Codebook

# 256-entry inverse-dB lookup (Vorbis I spec section 7.2.3 lists it
# literally). Closed form: table[i] = 10 ** (7 * (i - 255) / 256), i.e. a
# -140 dB range in 256 steps. Endpoints check out against the spec's literal
# table: [0] == 1.0649863e-07, [255] == 1.0. Values are rounded through
# float32 to match the published single-precision table.
INVERSE_DB_TABLE = (
    (10.0 ** (7.0 * (np.arange(256, dtype=np.float64) - 255) / 256.0))
    .astype(np.float32)
    .astype(np.float64)
)


@dataclass
class FloorData:
    """Per-(frame, channel) floor decode result."""

    unused: bool
    # floor1: final post Y values (after unwrap) and step2 flags, in x order
    posts: np.ndarray | None = None  # int32 [n_posts]
    step2: np.ndarray | None = None  # bool  [n_posts]
    # floor1: coded values (pre-unwrap prediction residuals) — the ys wire
    # ships these and runs the unwrap cascade on device (ops/floor.py)
    ys: np.ndarray | None = None  # int64 [n_posts]
    # floor0: amplitude + LSP coefficients
    amplitude: int = 0
    coefficients: np.ndarray | None = None  # float32 [order]
    # bit accounting (reference FloorData tracks per-channel decode state)
    bits_read: int = 0


class Floor0:
    """LSP floor (spec section 6; reference NVorbis/Floor0.cs:9)."""

    floor_type = 0

    def __init__(self, br: BitReader, channels: int, blocksizes: tuple[int, int],
                 codebooks: list[Codebook]):
        self.order = br.read_bits(8)
        self.rate = br.read_bits(16)
        self.bark_map_size = br.read_bits(16)
        self.amplitude_bits = br.read_bits(6)
        self.amplitude_offset = br.read_bits(8)
        num_books = br.read_bits(4) + 1
        self.books: list[Codebook] = []
        for _ in range(num_books):
            idx = br.read_bits(8)
            if idx >= len(codebooks):
                raise InvalidDataError("floor0 book index out of range")
            book = codebooks[idx]
            if not book.has_lookup or book.dimensions < 1:
                raise InvalidDataError("floor0 book lacks a value mapping")
            self.books.append(book)
        if self.order < 1 or self.rate < 1 or self.bark_map_size < 1:
            raise InvalidDataError("bad floor0 configuration")
        self._book_bits = ilog(num_books)
        # bark map per blocksize (spec 6.2.3), cached
        self._maps = {n: self._bark_map(n) for n in blocksizes}

    def _bark_map(self, n: int) -> np.ndarray:
        def bark(x):
            return (
                13.1 * np.arctan(0.00074 * x)
                + 2.24 * np.arctan(1.85e-8 * x * x)
                + 1e-4 * x
            )

        half = n // 2
        i = np.arange(half, dtype=np.float64)
        foobar = np.floor(
            bark(self.rate * i / n) * self.bark_map_size / bark(0.5 * self.rate)
        )
        return np.minimum(foobar, self.bark_map_size - 1).astype(np.int64)

    def unpack(self, br: BitReader) -> FloorData:
        amplitude = br.read_bits(self.amplitude_bits)
        if amplitude <= 0 or br.overrun:
            return FloorData(unused=True)
        book_num = br.read_bits(self._book_bits)
        if book_num >= len(self.books):
            return FloorData(unused=True)  # spec: undecodable -> unused
        book = self.books[book_num]
        coeffs: list[float] = []
        last = 0.0
        while len(coeffs) < self.order:
            vec = book.decode_vq(br)
            if vec is None:
                return FloorData(unused=True)  # EOP mid-floor zeroes channel
            for v in vec:
                coeffs.append(float(v) + last)
            last = coeffs[-1]
        return FloorData(
            unused=False,
            amplitude=amplitude,
            coefficients=np.array(coeffs[: self.order], dtype=np.float32),
        )

    def synthesize(self, data: FloorData, n: int) -> np.ndarray:
        """Curve of length n//2 (spec 6.2.3 products over LSP cosines)."""
        half = n // 2
        if data.unused:
            return np.zeros(half, dtype=np.float64)
        m = self._maps[n]
        omega = np.pi * m.astype(np.float64) / self.bark_map_size
        cos_w = np.cos(omega)  # [half]
        coeffs = data.coefficients.astype(np.float64)
        cos_c = np.cos(coeffs)  # [order]
        order = self.order
        # products of 4*(cos(c_j) - cos_w)^2 over even/odd j
        def prod_over(idx):
            if len(idx) == 0:
                return np.ones_like(cos_w)
            t = 4.0 * (cos_c[idx][None, :] - cos_w[:, None]) ** 2
            return np.prod(t, axis=1)

        if order % 2 == 1:
            p = (1.0 - cos_w**2) * prod_over(np.arange(1, order, 2))
            q = 0.25 * prod_over(np.arange(0, order, 2))
        else:
            p = (1.0 - cos_w) / 2.0 * prod_over(np.arange(1, order, 2))
            q = (1.0 + cos_w) / 2.0 * prod_over(np.arange(0, order, 2))
        denom = np.sqrt(p + q)
        denom = np.where(denom == 0, 1e-9, denom)
        amp_max = (1 << self.amplitude_bits) - 1
        linear = np.exp(
            0.11512925
            * (data.amplitude * self.amplitude_offset / (amp_max * denom) - self.amplitude_offset)
        )
        return linear


class Floor1:
    """Piecewise-linear floor (spec section 7; reference NVorbis/Floor1.cs:13)."""

    floor_type = 1
    RANGES = (256, 128, 86, 64)

    def __init__(self, br: BitReader, channels: int, blocksizes: tuple[int, int],
                 codebooks: list[Codebook]):
        partitions = br.read_bits(5)
        self.partition_classes = [br.read_bits(4) for _ in range(partitions)]
        max_class = max(self.partition_classes, default=-1)
        self.class_dims: list[int] = []
        self.class_subclasses: list[int] = []
        self.class_masterbooks: list[Codebook | None] = []
        self.subclass_books: list[list[Codebook | None]] = []
        for _ in range(max_class + 1):
            dims = br.read_bits(3) + 1
            subs = br.read_bits(2)
            master = None
            if subs > 0:
                mi = br.read_bits(8)
                if mi >= len(codebooks):
                    raise InvalidDataError("floor1 masterbook out of range")
                master = codebooks[mi]
            books: list[Codebook | None] = []
            for _ in range(1 << subs):
                bi = br.read_bits(8) - 1
                if bi >= len(codebooks):
                    raise InvalidDataError("floor1 subclass book out of range")
                books.append(codebooks[bi] if bi >= 0 else None)
            self.class_dims.append(dims)
            self.class_subclasses.append(subs)
            self.class_masterbooks.append(master)
            self.subclass_books.append(books)
        self.multiplier = br.read_bits(2) + 1
        rangebits = br.read_bits(4)
        xs: list[int] = [0, 1 << rangebits]
        for cls in self.partition_classes:
            for _ in range(self.class_dims[cls]):
                xs.append(br.read_bits(rangebits))
        if br.overrun:
            raise InvalidDataError("floor1 configuration truncated")
        if len(xs) > 65:
            raise InvalidDataError("floor1 has more than 65 posts")
        if len(set(xs)) != len(xs):
            raise InvalidDataError("floor1 X values must be unique")
        self.xs = np.array(xs, dtype=np.int64)
        self.n_posts = len(xs)
        self.range = self.RANGES[self.multiplier - 1]
        self._y_bits = ilog(self.range - 1)
        # precompute neighbors + sort order (reference Floor1.cs:108-149)
        self.sort_order = np.argsort(self.xs, kind="stable")
        self.low_neighbor = np.zeros(self.n_posts, dtype=np.int64)
        self.high_neighbor = np.zeros(self.n_posts, dtype=np.int64)
        for i in range(2, self.n_posts):
            below = [j for j in range(i) if xs[j] < xs[i]]
            above = [j for j in range(i) if xs[j] > xs[i]]
            self.low_neighbor[i] = max(below, key=lambda j: xs[j])
            self.high_neighbor[i] = min(above, key=lambda j: xs[j])

    # -- unpack (spec 7.2.2) ------------------------------------------------------

    def unpack(self, br: BitReader) -> FloorData:
        if not br.read_bit() or br.overrun:
            return FloorData(unused=True)
        rng = self.range
        ys = np.zeros(self.n_posts, dtype=np.int64)
        ys[0] = br.read_bits(self._y_bits)
        ys[1] = br.read_bits(self._y_bits)
        offset = 2
        for cls in self.partition_classes:
            cdim = self.class_dims[cls]
            cbits = self.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits > 0:
                cval = self.class_masterbooks[cls].decode_scalar(br)
                if cval < 0:
                    return FloorData(unused=True)
            for j in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                if book is not None:
                    v = book.decode_scalar(br)
                    if v < 0:
                        return FloorData(unused=True)
                    ys[offset + j] = v
                else:
                    ys[offset + j] = 0
            offset += cdim
        if br.overrun:
            return FloorData(unused=True)
        posts, step2 = self._unwrap(ys)
        return FloorData(unused=False, posts=posts, step2=step2, ys=ys)

    def _unwrap(self, ys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Amplitude value synthesis: prediction + room folding
        (spec 7.2.2 step 2; reference Floor1.UnwrapPosts:270)."""
        n = self.n_posts
        rng = self.range
        final = np.zeros(n, dtype=np.int64)
        step2 = np.zeros(n, dtype=bool)
        final[0], final[1] = ys[0], ys[1]
        step2[0] = step2[1] = True
        xs = self.xs
        for i in range(2, n):
            low = self.low_neighbor[i]
            high = self.high_neighbor[i]
            predicted = render_point(
                int(xs[low]), int(final[low]), int(xs[high]), int(final[high]), int(xs[i])
            )
            val = int(ys[i])
            highroom = rng - predicted
            lowroom = predicted
            room = 2 * min(highroom, lowroom)
            if val:
                step2[low] = True
                step2[high] = True
                step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + predicted
                    else:
                        final[i] = predicted - val + highroom - 1
                else:
                    if val & 1:
                        final[i] = predicted - ((val + 1) >> 1)
                    else:
                        final[i] = predicted + (val >> 1)
            else:
                step2[i] = False
                final[i] = predicted
        # clamp: malformed streams can carry book values larger than the
        # floor range, driving the fold negative / past the range — clamped
        # here so every consumer (scalar render, u8 device transport, C++
        # mirror) sees in-range posts instead of wrapping or crashing
        np.clip(final, 0, rng - 1, out=final)
        return final, step2

    # -- synthesis (spec 7.2.3/7.2.4) ----------------------------------------------

    def synthesize(self, data: FloorData, n: int) -> np.ndarray:
        half = n // 2
        if data.unused:
            return np.zeros(half, dtype=np.float64)
        ylut = np.zeros(half, dtype=np.int64)
        mult = self.multiplier
        order = self.sort_order
        xs = self.xs
        final = data.posts
        step2 = data.step2
        lx, ly = 0, int(final[order[0]]) * mult
        hx = 0
        hy = ly
        for k in range(1, self.n_posts):
            j = order[k]
            if not step2[j]:
                continue
            hx = int(xs[j])
            hy = int(final[j]) * mult
            if hx > lx:
                render_line(lx, ly, hx, hy, ylut, half)
            lx, ly = hx, hy
        if hx < half:
            ylut[hx:] = hy
        return INVERSE_DB_TABLE[np.clip(ylut, 0, 255)]


def render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    """Integer line interpolation (spec 9.2.6; reference Floor1.RenderPoint:355)."""
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def render_line(x0: int, y0: int, x1: int, y1: int, v: np.ndarray, limit: int) -> None:
    """Bresenham render into v[x0:min(x1,limit)] (spec 9.2.7). The closed
    form y(x) = y0 + sign(dy)*floor(|dy|(x-x0)/adx) is exactly the spec's
    err-accumulation loop; vectorized here (reference RenderLineMulti:372)."""
    adx = x1 - x0
    dy = y1 - y0
    end = min(x1, limit)
    if end <= x0:
        return
    k = np.arange(0, end - x0, dtype=np.int64)
    vals = y0 + np.sign(dy) * ((abs(dy) * k) // adx)
    v[x0:end] = vals
