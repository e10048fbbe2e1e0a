"""Each frame's H axis split into horizontal bands over the ranks of a
space group (``pred_vmn --space N``; the port's counterpart of the JAX
package's ``space`` mesh axis, tcvom_tpu/parallel/mesh.py:27-34, :76-99,
where GSPMD inserts the convolutions' halos and the cross-shard
reductions).

A space group is N consecutive ranks that sweep the same samples
(:func:`space_group`); each computes one band of every frame
(:func:`band_table`: boundaries on multiples of 32 input rows, the largest
total stride of the backbones, so that every stride-2 op, 2x2 pool, x8
resize and the OS-8 grid divide evenly inside each band). Under
:func:`banded` the ops that couple rows read the layout (:func:`current`)
and take what they need from the other bands:

- :meth:`Bands.rows`: global rows ``[lo, hi)`` of a band-split tensor,
  zero (or ``fill``, or the frame's reflection) outside the frame: the
  convolutions' and pools' halos, GCA's reflection padding, and FAM's
  keys;
- :meth:`Bands.window`: the rows a sliding window (a conv, a pool) reads
  for this band of its output;
- :meth:`Bands.sum_over_bands`: a sum over the bands (GroupNorm's
  statistics, adaptive pooling's bins);
- :meth:`Bands.gather_bands`: the whole frame on every rank of the group.

Every exchange is one ``all_reduce`` over the group of a buffer that is
zero except where this rank writes: exact (x + 0 = x), and one code path
for NCCL and for gloo, which runs ``all_reduce`` on CUDA tensors but
``send``/``recv`` on CPU tensors only.

A tensor's resolution is read from its rows: the band's input rows over
the tensor's (a power of two up to 32). Tensors that are whole on every
rank (the PPM's pooled maps) run under :func:`whole`, where no op reads a
layout. Inference only: nothing here has a gradient.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from tcvom_tpu_torch.parallel import ddp

BLOCK = 32                      # the backbones' largest total stride


def band_table(height: int, n: int) -> tuple[tuple[int, int], ...]:
    """``n`` bands ``(lo, hi)`` of ``height`` input rows: whole blocks of
    32 rows, spread as evenly as they go, the first bands one block longer
    (1088 over 4: 9, 9, 8, 8 blocks)."""
    if height % BLOCK:
        raise ValueError(f"H = {height} is not a multiple of {BLOCK}")
    blocks = height // BLOCK
    if blocks < n:
        raise ValueError(f"H = {height} has {blocks} blocks of {BLOCK} rows, "
                         f"fewer than the {n} ranks of a space group")
    out, lo = [], 0
    for i in range(n):
        hi = lo + BLOCK * (blocks // n + (i < blocks % n))
        out.append((lo, hi))
        lo = hi
    return tuple(out)


def space_group(size: int):
    """This rank's space group: ``(group, ranks)``, the ``size``
    consecutive ranks it belongs to (a process group over them, None for
    one rank). Every rank makes every group, as ``dist.new_group``
    requires, so every rank calls this alike and once."""
    world, rank = ddp.world(), ddp.rank()
    if world % size:
        raise ValueError(f"{world} ranks do not split into space groups "
                         f"of {size}")
    mine = None
    for first in range(0, world, size):
        ranks = tuple(range(first, first + size))
        group = dist.new_group(list(ranks)) if size > 1 else None
        if rank in ranks:
            mine = (group, ranks)
    return mine


class Bands:
    """The band layout of one frame height over a space group, and its
    exchanges. ``counts`` tallies them by kind (``rows``, ``sum``,
    ``gather``): ``[calls, bytes this rank put in]``."""

    def __init__(self, height: int, group=None, ranks=(0,)):
        self.height = height
        self.group = group
        self.n = len(ranks)
        self.index = ranks.index(ddp.rank()) if self.n > 1 else 0
        self.bounds = band_table(height, self.n)
        self.lo, self.hi = self.bounds[self.index]
        self.counts: dict[str, list[int]] = {}

    def __repr__(self):
        return (f"Bands(height={self.height}, rank {self.index} of "
                f"{self.n}, rows [{self.lo}, {self.hi}))")

    # -- the layout at a tensor's resolution ---------------------------------

    def scale(self, rows: int) -> int:
        """The resolution of a band of ``rows`` rows: input rows per row
        (1, 2, 4, ..., 32). Raises if ``rows`` is no band at such a
        resolution."""
        f = (self.hi - self.lo) // rows if rows else 0
        if not f or f * rows != self.hi - self.lo or f & (f - 1) \
                or f > BLOCK:
            raise ValueError(f"{rows} rows are not a band of {self}")
        return f

    def span(self, rows: int) -> tuple[int, int, int]:
        """``(lo, hi, height)`` of the band of ``rows`` rows, at its own
        resolution."""
        f = self.scale(rows)
        return self.lo // f, self.hi // f, self.height // f

    def crop(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows (axis ``dim``) of ``x``, whole on every rank,
        at whatever resolution ``x`` has."""
        f = self.height // x.shape[dim]
        if f * x.shape[dim] != self.height:
            raise ValueError(f"{x.shape[dim]} rows are not a frame of "
                             f"{self.height}")
        return x.narrow(dim, self.lo // f, (self.hi - self.lo) // f)

    def _all_reduce(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        count = self.counts.setdefault(kind, [0, 0])
        count[0] += 1
        count[1] += t.numel() * t.element_size()
        if self.n > 1:
            dist.all_reduce(t, group=self.group)
        return t

    # -- the exchanges -------------------------------------------------------

    def rows(self, x: torch.Tensor, lo: int, hi: int,
             fill: float | str = 0.0) -> torch.Tensor:
        """Global rows ``[lo, hi)`` (axis -2) of the band-split ``x``,
        ``fill`` outside ``[0, height)``; with ``fill="reflect"`` the
        frame's rows reflected about its edge rows instead (row -1 is row
        1, row ``height`` row ``height - 2``: ``nn.ReflectionPad2d``).
        ``lo`` and ``hi`` lie alike about
        every rank's band (``lo - band lo`` and ``hi - band hi`` are the
        same on each), so that every rank of the group makes the same
        exchange.

        Each rank puts its top and bottom ``min(halo, band rows)`` rows
        into its own slots of a zeroed buffer (``halo`` the longer of the
        two reaches past the band), the group sums it, and each rank takes
        the rows it needs from the slots. That is enough when the halo is
        longer than a neighbouring band: a row within ``halo`` of this
        band's edge is within ``halo`` of its own band's edge."""
        f = self.scale(x.shape[-2])
        b_lo, b_hi = self.lo // f, self.hi // f
        halo = max(b_lo - lo, hi - b_hi, 0)
        if not halo:
            return x.narrow(-2, lo - b_lo, hi - lo)
        buf = x.new_zeros((self.n, 2) + x.shape[:-2] + (halo,)
                          + x.shape[-1:])
        k = min(halo, b_hi - b_lo)
        buf[self.index, 0, ..., :k, :] = x[..., :k, :]
        buf[self.index, 1, ..., halo - k:, :] = x[..., b_hi - b_lo - k:, :]
        self._all_reduce("rows", buf)
        # each global row's place in src = cat(x, every rank's top and
        # bottom slots, a fill row); a bottom slot is filled from its end
        reflect = fill == "reflect"
        src = torch.cat([x, buf.movedim(-2, 2).flatten(0, 2).movedim(0, -2),
                         torch.full_like(x[..., :1, :],
                                         0.0 if reflect else fill)], dim=-2)
        place = {}
        for j, (a, b) in enumerate(self.bounds):
            a, b, base = a // f, b // f, b_hi - b_lo + 2 * j * halo
            for t in range(min(halo, b - a)):
                place[a + t] = base + t
                place[b - 1 - t] = base + 2 * halo - 1 - t
        place.update((g, g - b_lo) for g in range(b_lo, b_hi))
        outside, height = src.shape[-2] - 1, self.height // f
        idx = []
        for g in range(lo, hi):
            if reflect and not 0 <= g < height:
                g = -g if g < 0 else 2 * (height - 1) - g
            if g not in place and 0 <= g < height:
                raise ValueError(f"row {g} lies beyond the halo of {self}")
            idx.append(place.get(g, outside))
        idx = torch.tensor(idx, device=x.device)
        return src.index_select(-2, idx)

    def window(self, x: torch.Tensor, kernel: int, stride: int = 1,
               dilation: int = 1, padding: int = 0,
               fill: float | str = 0.0) -> torch.Tensor:
        """The rows of the band-split ``x`` that a sliding window over H
        (``kernel``, ``stride``, ``dilation``, ``padding``, with ``fill``
        as its padding, as in :meth:`rows`) reads for this rank's band of its output, to be
        run with no padding on H: ``[o_lo * stride - padding, (o_hi - 1) *
        stride - padding + dilation * (kernel - 1) + 1)`` for the output
        band ``[o_lo, o_hi)``. The op must keep the layout: its output has
        ``height / stride`` rows."""
        lo, hi, height = self.span(x.shape[-2])
        out = (height + 2 * padding - dilation * (kernel - 1) - 1) // stride
        if lo % stride or hi % stride or out + 1 != height // stride:
            raise ValueError(f"a window of {kernel} rows, stride {stride}, "
                             f"dilation {dilation}, padding {padding} does "
                             f"not keep the bands of {self}")
        return self.rows(x, lo - padding, hi - stride - padding
                         + dilation * (kernel - 1) + 1, fill)

    def sum_over_bands(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the bands: the same on every rank."""
        return self._all_reduce("sum", t.clone(
            memory_format=torch.contiguous_format))

    def gather_bands(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole frame (axis ``dim``) of the band-split ``x`` on every
        rank of the group."""
        b_lo, b_hi, height = self.span(x.shape[dim])
        shape = list(x.shape)
        shape[dim] = height
        out = x.new_zeros(shape)
        out.narrow(dim, b_lo, b_hi - b_lo).copy_(x)
        return self._all_reduce("gather", out)


# the layout the band ops read: set by ``banded``, cleared by ``whole``
_BANDS: contextvars.ContextVar[Bands | None] = contextvars.ContextVar(
    "bands", default=None)


def current() -> Bands | None:
    """The layout of the band-split tensors the ops receive now, None
    when their input is whole."""
    return _BANDS.get()


@contextlib.contextmanager
def _set(bands: Bands | None):
    token = _BANDS.set(bands)
    try:
        yield bands
    finally:
        _BANDS.reset(token)


def banded(bands: Bands):
    """Band mode: within the block the ops' inputs are ``bands``' bands."""
    return _set(bands)


def whole():
    """Within band mode, a block whose tensors are whole on every rank
    (the PPM's pooled maps): the ops there run as they do outside."""
    return _set(None)
