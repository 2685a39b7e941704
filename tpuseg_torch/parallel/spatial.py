"""Spatial (H-sharded) inference and training (port of
``tpuseg/parallel/spatial.py``).

The JAX package shards an image batch over HEIGHT and lets XLA's SPMD pass
insert the convolution halos and the cross-shard reductions.  Here each
rank is a process (``parallel/mesh.py::run_ranks``) that holds rows
``[r*H/n, (r+1)*H/n)`` of every full-resolution map, and every byte that
crosses ranks goes through the helpers of this module:

* ``exchange_halo`` -- the rows above and below a shard that a convolution
  (or the four 3x3 depthwise convolutions of one ``ir_chain`` launch)
  reads; its backward sends each halo row's gradient back to its owner;
* ``space_sum`` / ``space_mean`` / ``space_max`` / ``space_argmax`` /
  ``owner_value`` -- reductions over the pixels of an image whose rows lie
  on several ranks (``space_argmax``: first global index on ties, as
  ``argmax`` takes it on one device);
* ``gather_rows`` / ``take_rows`` -- a coarse map replicated on every rank
  where a shard would hold too few rows for the next convolution or an odd
  count before a pool, and a replicated map's rows for a sharded level;
* ``masked_softmax`` -- the per-instance softmax of the attention score
  over a row of pixels split across ranks: the kernel's partial (max, sum
  of exp) per rank, combined over the ranks, then ``p``; the backward
  all-reduces the row dots between its two launches.

Which rows a map holds is a ``Rows``: sharded (``ranges[q]`` = the rows
rank q holds of a canvas) or replicated.  The model's code says at which
pyramid level it runs (``level(factor, min_rows)``): a level stays sharded
while its row count divides over the ranks and each rank holds at least
``min_rows`` rows (``UNET_ROWS`` for the UNet, the heads and the stem, whose
3x3 convolutions read one row of halo; ``DECODE_ROWS`` for the pyramid
decode, whose ``ir_chain`` reads four), and is replicated below that (the
JAX test allows such gathers only for low-channel maps at <= 1/4
resolution).  The windowed decode's levels hold each window's rows where
the ranks hold them (``Rows.window``).

Two kinds of reduction stay apart: ``parallel/mesh.py``'s batch reductions
sum over ranks that hold *different samples* and are the plain local
reduction under a spatial context (``mesh.data_ranks``); the reductions
here sum row partials of the *same samples*.

With no spatial context (or one rank) every helper is the plain local op,
so the one-process path keeps its outputs bit for bit and its kernel
launches.

``recording()`` logs the shape and dtype of every tensor the helpers move
(off by default): the port's counterpart of the HLO checks of
``tests/test_spatial_sharding.py``.

Entry points (the JAX names, a port ``Mesh`` for the JAX mesh; call them
inside the ranks of ``run_ranks``): ``spatial_sharding``, ``shard_spatial``,
``make_semantic_spatial``, ``make_infer_spatial``, ``replicate_state``,
``shard_train_batch`` and ``make_train_spatial``.  Outputs stay H-sharded
on their ranks; the caller gathers them to compare or to write.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpuseg_torch.parallel import mesh as _mesh
from tpuseg_torch.parallel.mesh import Mesh

UNET_ROWS = 1    # 3x3 convolutions with dilation 1: one row of halo
DECODE_ROWS = 4  # ir_chain: four 3x3 depthwise convolutions in one launch


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of a map at one level: the canvas ``[c0, c1)`` (global
    rows at this level) and, when sharded, ``ranges[q] = (lo, hi)``, the
    canvas rows rank q holds (contiguous, in rank order, maybe empty);
    ``ranges`` None: every rank holds the whole canvas."""

    c0: int
    c1: int
    rank: int
    ranges: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def sharded(self) -> bool:
        return self.ranges is not None

    @property
    def lo(self) -> int:
        return self.ranges[self.rank][0] if self.sharded else self.c0

    @property
    def hi(self) -> int:
        return self.ranges[self.rank][1] if self.sharded else self.c1

    @property
    def height(self) -> int:
        return self.c1 - self.c0

    def window(self, origin: int, length: int) -> "Rows":
        """The rows ``[origin, origin + length)`` as a canvas of their own:
        each rank holds its rows of it (sharded), or all (replicated)."""
        end = origin + length
        if not self.sharded:
            return Rows(origin, end, self.rank)
        clip = lambda v: min(max(v, origin), end)  # noqa: E731
        return Rows(origin, end, self.rank,
                    tuple((clip(lo), clip(hi)) for lo, hi in self.ranges))


class _Context:
    def __init__(self, mesh: Mesh, height: int, recorder: Optional[list]):
        self.mesh = mesh
        self.n = mesh.size
        self.rank = mesh.rank
        self.height = height
        self.recorder = recorder
        self.stack: List[Rows] = []
        self.gloo = dist.get_backend() == "gloo"


_CTX: List[Optional[_Context]] = [None]
_RECORDER: List[Optional[list]] = [None]


def active() -> bool:
    """True inside a spatial context of more than one rank."""
    return _CTX[0] is not None


@contextlib.contextmanager
def spatial_context(mesh: Mesh, height: int):
    """Within the block this rank holds rows ``[r*height/n,
    (r+1)*height/n)`` of every full-resolution map of the same samples
    that its peers hold; the batch reductions of ``parallel/mesh.py``
    become local.  A mesh of one rank changes nothing."""
    if mesh.size == 1:
        yield
        return
    if _CTX[0] is not None:
        raise RuntimeError("spatial_context: already inside one")
    check_rows(height, mesh.size)
    _CTX[0] = _Context(mesh, height, _RECORDER[0])
    before = _mesh.set_spatial(True)
    try:
        yield
    finally:
        _CTX[0] = None
        _mesh.set_spatial(before)


@contextlib.contextmanager
def recording():
    """Within the block, each tensor a helper moves across ranks is logged
    as ``{"op", "shape", "dtype"}`` into the yielded list (``op``: "halo",
    "halo_grad", "gather", "gather_grad", "take_grad", "reduce", "max",
    "argmax")."""
    log: list = []
    old = _RECORDER[0]
    _RECORDER[0] = log
    if _CTX[0] is not None:
        _CTX[0].recorder = log
    try:
        yield log
    finally:
        _RECORDER[0] = old
        if _CTX[0] is not None:
            _CTX[0].recorder = old


def _record(op: str, t: torch.Tensor) -> None:
    ctx = _CTX[0]
    if ctx is not None and ctx.recorder is not None:
        ctx.recorder.append({"op": op, "shape": tuple(t.shape),
                             "dtype": str(t.dtype).replace("torch.", "")})


def check_rows(height: int, n: int) -> None:
    """Raise ``ValueError`` unless ``height`` rows divide over ``n`` ranks
    with at least ``DECODE_ROWS`` rows each."""
    if height % n:
        raise ValueError(f"H={height} does not divide over {n} ranks: pad "
                         "the images to a multiple of the ranks")
    if height // n < DECODE_ROWS:
        raise ValueError(f"H={height} over {n} ranks leaves fewer than "
                         f"{DECODE_ROWS} rows a rank")


# ------------------------------ layouts ---------------------------------

def level_rows(factor: int, min_rows: int = UNET_ROWS) -> Optional[Rows]:
    """The full canvas at ``factor`` (None outside a context): sharded while
    its rows divide over the ranks with ``min_rows`` or more each."""
    ctx = _CTX[0]
    if ctx is None:
        return None
    h = ctx.height // factor
    if ctx.height % factor == 0 and h % ctx.n == 0 and h // ctx.n >= min_rows:
        per = h // ctx.n
        ranges = tuple((q * per, (q + 1) * per) for q in range(ctx.n))
        return Rows(0, h, ctx.rank, ranges)
    return Rows(0, h, ctx.rank)


@contextlib.contextmanager
def at_rows(r: Optional[Rows]):
    """Within the block the helpers take the maps' rows as ``r``."""
    ctx = _CTX[0]
    if ctx is None or r is None:
        yield
        return
    ctx.stack.append(r)
    try:
        yield
    finally:
        ctx.stack.pop()


def local():
    """Within the block the helpers reduce locally: for values that are
    not maps of pixels (per-sample logits), which every rank holds whole."""
    ctx = _CTX[0]
    return at_rows(None if ctx is None else Rows(0, 0, ctx.rank))


def level(factor: int, min_rows: int = UNET_ROWS):
    """``at_rows(level_rows(factor, min_rows))``."""
    return at_rows(level_rows(factor, min_rows))


def rows() -> Optional[Rows]:
    """The current rows: the innermost ``at_rows``, else full resolution."""
    ctx = _CTX[0]
    if ctx is None:
        return None
    return ctx.stack[-1] if ctx.stack else level_rows(1)


def sharded() -> bool:
    """True where the current maps' rows lie on several ranks."""
    r = rows()
    return r is not None and r.sharded


def row_offset() -> int:
    """The canvas row of this rank's first row of the current maps (0
    outside a context)."""
    r = rows()
    return 0 if r is None else r.lo - r.c0


def canvas_rows(h_local: int) -> int:
    """The canvas height of the current maps (``h_local`` where they are
    not sharded)."""
    r = rows()
    return r.height if r is not None and r.sharded else h_local


# ----------------------------- collectives ------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    """16-bit floats as bytes (gloo gathers no bfloat16)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order.  gloo moves CUDA
    tensors through host memory (it gathers CPU tensors only)."""
    ctx = _CTX[0]
    src = _bits(t.contiguous())
    host = ctx.gloo and src.is_cuda
    if host:
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(ctx.n)]
    dist.all_gather(outs, src)
    if host:
        outs = [o.to(t.device) for o in outs]
    return [o.view(t.dtype) for o in outs]


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op)
    return t


def reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the ranks of per-rank row partials; its
    backward sums the cotangents over the ranks (every rank's input feeds
    every rank's copy of the result)."""
    _record("reduce", x)
    return _mesh.all_reduce_sum(x)


def space_sum(x: torch.Tensor, dim=None, keepdim: bool = False
              ) -> torch.Tensor:
    """``x.sum(dim)`` (``x.sum()`` for None) over dims that hold the
    current maps' rows, summed over the ranks where those rows are
    sharded."""
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return reduce_rows(s) if sharded() else s


def space_mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` over dims that hold the current maps' rows (``dim``
    covers the row axis, or a flattened axis of rows x columns)."""
    if not sharded():
        return x.mean(dim=dim, keepdim=keepdim)
    r = rows()
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    local = int(np.prod([x.shape[d] for d in dims]))
    count = local // (r.hi - r.lo) * r.height
    return space_sum(x, dim, keepdim) / count


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` of a tensor of the current maps' pixels (any layout):
    its sum and element count summed over the ranks."""
    if not sharded():
        return x.mean()
    total = reduce_rows(torch.stack([x.sum(), x.new_tensor(float(x.numel()))]))
    return total[0] / total[1]


def space_max(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``x.amax(dim)`` over the current maps' pixels (no gradient)."""
    m = x.detach().amax(dim=dim, keepdim=keepdim)
    if sharded():
        _record("max", m)
        m = _all_reduce_(m.contiguous(), dist.ReduceOp.MAX)
    return m


def space_argmax(flat: torch.Tensor, width: int) -> torch.Tensor:
    """``flat.argmax(dim=1)`` of (B, h*w) row-major maps as global flat
    indices: the largest value, the first global index on ties."""
    i = flat.argmax(dim=1)
    if not sharded():
        return i
    v = flat.gather(1, i[:, None])[:, 0]
    gi = i + row_offset() * width
    pair = torch.stack([v.detach().double(), gi.double()], dim=1)
    _record("argmax", pair)
    every = torch.stack(_all_gather(pair))  # (n, B, 2), rank = row order
    vals = every[..., 0]
    best = vals.max(dim=0).values
    first = (vals == best[None]).to(torch.int8).argmax(dim=0)
    return every[first, torch.arange(flat.shape[0], device=flat.device),
                 1].long()


def owner_value(flat: torch.Tensor, index: torch.Tensor,
                width: int) -> torch.Tensor:
    """``flat.gather(1, index[:, None])[:, 0]`` with ``index`` global flat
    indices: the owning rank reads it, every rank gets it (differentiable
    where ``flat`` is)."""
    if not sharded():
        return flat.gather(1, index[:, None])[:, 0]
    local = index - row_offset() * width
    mine = (local >= 0) & (local < flat.shape[1])
    v = flat.gather(1, local.clamp(0, max(flat.shape[1] - 1, 0))[:, None])
    v = torch.where(mine, v[:, 0], torch.zeros_like(v[:, 0]))
    return reduce_rows(v)


# --------------------------------- halos --------------------------------

def _owner(r: Rows, g: int) -> int:
    for q, (lo, hi) in enumerate(r.ranges):
        if lo <= g < hi:
            return q
    raise AssertionError(f"row {g} has no owner in {r}")


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r: Rows, up: int, down: int, zeros: bool):
        lo, hi = r.lo, r.hi
        h = hi - lo
        n_, c, _, w = x.shape
        # what the neighbours read: the last `up` rows (right-aligned) and
        # the first `down` rows of this rank's rows
        piece = x.new_zeros((n_, c, up + down, w))
        bu, td = min(up, h), min(down, h)
        if bu:
            piece[:, :, up - bu:up] = x[:, :, h - bu:]
        if td:
            piece[:, :, up:up + td] = x[:, :, :td]
        _record("halo", piece)
        pieces = _all_gather(piece)
        above = list(range(max(r.c0, lo - up), lo)) if h else []
        below = list(range(hi, min(r.c1, hi + down))) if h else []
        parts = []
        fill_up = (up - len(above)) if (zeros and h) else 0
        fill_dn = (down - len(below)) if (zeros and h) else 0
        if fill_up:
            parts.append(x.new_zeros((n_, c, fill_up, w)))
        for g in above:
            q = _owner(r, g)
            k = up - (r.ranges[q][1] - g)
            parts.append(pieces[q][:, :, k:k + 1])
        parts.append(x)
        for g in below:
            q = _owner(r, g)
            k = up + g - r.ranges[q][0]
            parts.append(pieces[q][:, :, k:k + 1])
        if fill_dn:
            parts.append(x.new_zeros((n_, c, fill_dn, w)))
        ctx.meta = (r, up, down, fill_up, len(above), len(below), h)
        return torch.cat(parts, dim=2) if len(parts) > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        r, up, down, fill_up, n_above, n_below, h = ctx.meta
        lo, hi = r.lo, r.hi
        a = fill_up + n_above
        gx = g[:, :, a:a + h].clone()
        n_, c, _, w = g.shape
        piece = g.new_zeros((n_, c, up + down, w))
        if n_above:
            piece[:, :, up - n_above:up] = g[:, :, fill_up:a]
        if n_below:
            piece[:, :, up:up + n_below] = g[:, :, a + h:a + h + n_below]
        _record("halo_grad", piece)
        pieces = _all_gather(piece)
        for q, (qlo, qhi) in enumerate(r.ranges):
            if q == r.rank or qlo == qhi:
                continue
            for p in range(up):
                row = qlo - up + p
                if lo <= row < hi:
                    gx[:, :, row - lo] += pieces[q][:, :, p]
            for p in range(down):
                row = qhi + p
                if lo <= row < hi:
                    gx[:, :, row - lo] += pieces[q][:, :, up + p]
        return gx, None, None, None, None


def exchange_halo(x: torch.Tensor, rows_up: int, rows_down: int,
                  edge: str = "zeros", r: Optional[Rows] = None
                  ) -> torch.Tensor:
    """``x`` (N, C, h, W), this rank's rows of sharded maps laid out as
    ``r`` (default: the current rows), with ``rows_up`` rows of the ranks
    above and ``rows_down`` of the ranks below.  Beyond the canvas:
    zero rows (``edge="zeros"``, a convolution's padding) or none
    (``"none"``: the result starts / ends at the canvas edge).  A rank
    with no rows takes part and gets ``x`` back."""
    r = r or rows()
    if edge not in ("zeros", "none"):
        raise ValueError(f"exchange_halo: unknown edge {edge!r}")
    return _Halo.apply(x, r, rows_up, rows_down, edge == "zeros")


def halo_start(r: Rows, rows_up: int) -> int:
    """Rows ``exchange_halo(edge="none")`` puts above this rank's first."""
    return r.lo - max(r.c0, r.lo - rows_up)


def conv2d(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for a convolution with zero row padding p; on sharded
    rows: p rows of halo each side, then the convolution without row
    padding."""
    if not sharded():
        return conv(x)
    ph, pw = conv.padding
    xe = exchange_halo(x, ph, ph) if ph else x
    if x.shape[2] == 0:  # no rows here (a window's): the halo all the same
        return x.new_zeros((x.shape[0], conv.out_channels, 0, x.shape[3]))
    return F.conv2d(xe, conv.weight, conv.bias, conv.stride, (0, pw),
                    conv.dilation, conv.groups)


def avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pooling, zero padding, divisor 9."""
    if not sharded():
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
    xe = exchange_halo(x, 1, 1)
    return F.avg_pool2d(xe, 3, 1, (0, 1), count_include_pad=True)


# ---------------------- gathers and layout changes ----------------------

class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r: Rows):
        most = max(hi - lo for lo, hi in r.ranges)
        pad = x.new_zeros((*x.shape[:2], most, x.shape[3]))
        pad[:, :, :x.shape[2]] = x
        pieces = _all_gather(pad)
        ctx.r = r
        out = torch.cat([p[:, :, :hi - lo] for p, (lo, hi)
                         in zip(pieces, r.ranges)], dim=2)
        _record("gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        r = ctx.r
        _record("gather_grad", g)
        g = _all_reduce_(g.contiguous().clone())
        return g[:, :, r.lo - r.c0:r.hi - r.c0].contiguous(), None


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c0: int, a: int, b: int, n: int):
        ctx.meta = (x.shape, c0, a, b, n)
        return x[:, :, a - c0:b - c0].clone()

    @staticmethod
    def backward(ctx, g):
        shape, c0, a, b, n = ctx.meta
        full = g.new_zeros(shape)
        full[:, :, a - c0:b - c0] = g
        _record("take_grad", full)
        # each rank read its rows of the replicated map: the replicated
        # map's gradient is the ranks' mean (the replicated convention)
        return _all_reduce_(full).div_(n), None, None, None, None


def gather_rows(x: torch.Tensor, r: Rows) -> torch.Tensor:
    """The whole canvas of sharded maps on every rank."""
    return _GatherRows.apply(x, r)


def take_rows(x: torch.Tensor, r: Rows, a: int, b: int) -> torch.Tensor:
    """Canvas rows ``[a, b)`` of replicated maps laid out as ``r``, as the
    rows a sharded consumer holds (the backward gives the replicated map
    the ranks' mean gradient)."""
    ctx = _CTX[0]
    if ctx is None:
        return x[:, :, a - r.c0:b - r.c0]
    return _TakeRows.apply(x, r.c0, a, b, ctx.n)


def relayout(x: torch.Tensor, src: Optional[Rows],
             dst: Optional[Rows]) -> torch.Tensor:
    """Maps of one level from the rows ``src`` to the rows ``dst`` (the
    same canvas): a gather where ``src`` is sharded and ``dst`` is not,
    this rank's rows where it is the other way round."""
    if src is None or src.sharded == dst.sharded:
        return x
    if src.sharded:
        return gather_rows(x, src)
    return take_rows(x, src, dst.lo, dst.hi)


def pool_rows(x: torch.Tensor, pool, factor: int, src: Optional[Rows],
              dst: Optional[Rows]) -> torch.Tensor:
    """``pool(x, factor)``, a ``factor`` x ``factor`` pooling that
    composes (``pool(pool(x, a), b) == pool(x, a * b)``: max, sum, or a
    mean of equal windows), from the rows ``src`` to the coarser rows
    ``dst``.  Where the shard's row count does not divide by ``factor``,
    it pools by their largest common factor, gathers that, and pools the
    rest on every rank."""
    if src is None or not src.sharded:
        return pool(x, factor)
    k = int(np.gcd(src.hi - src.lo, factor))
    y = pool(x, k) if k > 1 else x
    if k == factor and dst.sharded:
        return y
    if dst.sharded:
        raise ValueError("pool_rows: a sharded level under a shard whose "
                         "rows do not divide by the pool")
    y = gather_rows(y, Rows(src.c0 // k, src.c1 // k, src.rank, tuple(
        (lo // k, hi // k) for lo, hi in src.ranges)))
    return pool(y, factor // k) if factor > k else y


def upsample_rows(x: torch.Tensor, up, factor: int, src: Optional[Rows],
                  dst: Optional[Rows]) -> torch.Tensor:
    """``up(x)``, an upsampling by ``factor`` that maps each row to
    ``factor`` rows of its own (``ConvTranspose2d(k=s=factor)``,
    ``repeat_interleave``), from the rows ``src`` to the finer ``dst``."""
    if src is None or src.sharded or not dst.sharded:
        return up(x)
    a = dst.lo // factor
    b = -(-dst.hi // factor)
    y = up(take_rows(x, src, a, b))
    s = dst.lo - a * factor
    return y[:, :, s:s + dst.hi - dst.lo]


def upsample_bilinear_rows(x: torch.Tensor, width: int, src: Optional[Rows],
                           dst: Optional[Rows], crop=None) -> torch.Tensor:
    """``F.interpolate(x, (2h, width), bilinear, align_corners=False)``
    of maps laid out as ``src`` onto the rows ``dst`` of a canvas twice as
    tall (``dst``'s canvas is ``src``'s, or a window of it): this rank's
    rows and one row each side (none beyond the canvas, where the resize
    clamps), exact.  ``crop`` cuts the columns before the resize."""
    crop = crop or (lambda t: t)
    up = lambda t: F.interpolate(  # noqa: E731
        t, size=(2 * t.shape[2], width), mode="bilinear", align_corners=False)
    if dst is None:
        return up(crop(x))
    if not dst.sharded:
        return up(crop(x[:, :, dst.c0 // 2 - src.c0:dst.c1 // 2 - src.c0]))
    a = max(dst.lo // 2 - 1, dst.c0 // 2)
    b = min(-(-dst.hi // 2) + 1, dst.c1 // 2)
    if src.sharded:
        ext = exchange_halo(x, 1, 1, "none", src)
        e0 = max(src.lo - 1, src.c0)
        part = ext[:, :, a - e0:b - e0]
    else:
        part = take_rows(x, src, a, b)
    if dst.hi == dst.lo:
        return x.new_zeros((x.shape[0], x.shape[1], 0, width))
    y = up(crop(part))
    s = dst.lo - 2 * a
    return y[:, :, s:s + dst.hi - dst.lo]


# -------------------- masked softmax over split rows --------------------

def _combine_stats(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-rank (max, sum of exp(x - max)) pairs (B, N, 2), combined in
    rank order (log-sum-exp)."""
    m, s = parts[0][..., 0], parts[0][..., 1]
    for p in parts[1:]:
        pm, ps = p[..., 0], p[..., 1]
        mx = torch.maximum(m, pm)
        s = s * torch.exp(m - mx) + ps * torch.exp(pm - mx)
        m = mx
    return torch.stack([m, s], dim=-1).contiguous()


class _SplitMaskedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, mask):
        from tpuseg_torch.kernels import masked_softmax as ms

        part = ms.masked_softmax_stats(e, mask)
        _record("gather", part)
        stats = _combine_stats(_all_gather(part))
        p = ms.masked_softmax_apply(e, mask, stats)
        ctx.save_for_backward(p)
        ctx.mark_non_differentiable(mask)
        return p

    @staticmethod
    def backward(ctx, g):
        from tpuseg_torch.kernels import masked_softmax as ms

        (p,) = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dots = ms.masked_softmax_row_dots(p, g)  # (2, B, N): dot, active
        _record("reduce", dots)
        dots = _all_reduce_(dots)
        return ms.masked_softmax_tiles(p, g, dots), None


def masked_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``kernels.masked_softmax.masked_softmax`` with each row of pixels
    split over the ranks that hold the current maps' rows: e (B, hw_local)
    float32, mask (B, N, hw_local) -> p (B, N, hw_local).  CUDA tensors
    run the kernels' split entry points, CPU tensors their plain
    versions."""
    from tpuseg_torch.kernels import masked_softmax as ms

    if not sharded():
        return ms.masked_softmax(e, mask)
    return _SplitMaskedSoftmax.apply(e, mask)


def softmax_flat(logits: torch.Tensor) -> torch.Tensor:
    """``torch.softmax(logits, dim=1)`` of (B, hw_local) rows split over
    the ranks."""
    if not sharded():
        return torch.softmax(logits, dim=1)
    m = space_max(logits, 1, keepdim=True)
    z = torch.exp(logits - m)
    return z / space_sum(z, 1, keepdim=True)


def sample_flat(weights: torch.Tensor, generator, width: int) -> torch.Tensor:
    """One global flat index per row of (B, hw_local) nonnegative weights
    split over the ranks, drawn with probability proportional to the
    weight (``torch.multinomial(weights, 1)`` on one device; another
    random stream).  Every rank draws the same uniform numbers from its
    generator, so every rank gets the same indices."""
    if not sharded():
        return torch.multinomial(weights, 1, generator=generator)[:, 0]
    b, hwl = weights.shape
    w = weights.detach().double()
    local = w.sum(dim=1)
    _record("gather", local)
    masses = torch.stack(_all_gather(local))  # (n, B)
    u = torch.rand((b,), generator=generator, device=weights.device,
                   dtype=torch.float64) * masses.sum(dim=0)
    before = masses.cumsum(dim=0) - masses
    r = rows()
    mine = ((u >= before[r.rank]) & (u < before[r.rank] + masses[r.rank])
            & (masses[r.rank] > 0))
    cdf = w.cumsum(dim=1)
    k = torch.searchsorted(cdf, (u - before[r.rank])[:, None],
                           right=True)[:, 0].clamp(max=hwl - 1)
    idx = torch.where(mine, k + row_offset() * width, torch.zeros_like(k))
    _record("reduce", idx)
    return _all_reduce_(idx.contiguous())


# ------------------------------ entry points ----------------------------

def spatial_sharding(mesh: Mesh, height: int) -> Rows:
    """The rows of a ``height``-row full-resolution map over the mesh (the
    JAX ``NamedSharding`` over H): rank r holds ``[r*H/n, (r+1)*H/n)``.
    Raises ``ValueError`` when H does not divide over the ranks."""
    check_rows(height, mesh.size)
    per = height // mesh.size
    return Rows(0, height, mesh.rank,
                tuple((q * per, (q + 1) * per) for q in range(mesh.size)))


def shard_spatial(x, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of an image batch (B, H, W, C) (numpy or tensor),
    as a tensor on its device.  Raises ``ValueError`` when H does not
    divide over the ranks (pad beforehand; the bucketed predictor rounds
    H to multiples of 64)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    r = spatial_sharding(mesh, t.shape[1])
    return t[:, r.lo:r.hi].contiguous().to(mesh.device)


def replicate_state(state, mesh: Mesh):
    """Rank 0's state (a ``TrainState`` or a module) on every rank; call
    once before a ``make_train_spatial`` loop."""
    return _mesh.replicate(state, mesh)


def shard_train_batch(batch: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The spatial arrays of a training batch (4-D, (B, H, W, ...)) H-sharded,
    the per-sample ones whole, as tensors on this rank's device.  Raises
    ``ValueError`` when H does not divide over the ranks."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = shard_spatial(t, mesh) if t.dim() == 4 else t.to(mesh.device)
    return out


def _height(images_local: torch.Tensor, mesh: Mesh) -> int:
    return images_local.shape[1] * mesh.size


def make_semantic_spatial(model, mesh: Mesh,
                          dtype: Optional[torch.dtype] = None):
    """Returns ``fn(images_u8)``: this rank's rows (B, h, W, 3) uint8 ->
    its rows of the semantic probabilities (B, 2, h, W) float32, the model
    run in eval mode (``model.to_inference(dtype)`` first)."""
    from tpuseg_torch.runtime.predict import Predictor, tf32_off

    model = model.to(mesh.device).to_inference(dtype or torch.float32)
    f32 = (dtype or torch.float32) == torch.float32

    @torch.no_grad()
    def fn(images_u8):
        x = images_u8.to(mesh.device)
        with spatial_context(mesh, _height(x, mesh)), (
                tf32_off() if f32 else contextlib.nullcontext()):
            return model.semantic(Predictor._standardize(x)).float()

    return fn


def make_infer_spatial(model, mesh: Mesh, max_instances: Optional[int] = None,
                       stop_params=None, dtype: Optional[torch.dtype] = None):
    """Returns ``fn(images_u8)``: this rank's rows (B, h, W, 3) uint8 ->
    (its rows of sem_probs (B, 2, h, W) float32, its rows of the id map
    (B, h, W) int32, counts (B,) int32 on every rank): the full instance
    inference (semantic head, attention, extraction rounds, pyramid
    decode) with the image rows over the ranks.  Every rank runs the same
    rounds and makes the same collectives: each branch on data reads
    values already reduced over the ranks."""
    from tpuseg_torch.runtime.predict import Predictor, tf32_off

    dtype = dtype or torch.float32
    model = model.to(mesh.device).to_inference(dtype)
    k_static = max_instances or model.cfg.data.max_n_objects
    group = max(int(model.cfg.decoder.extract_group), 1)
    n_rounds = -(-k_static // group)

    @torch.no_grad()
    def fn(images_u8):
        x = images_u8.to(mesh.device)
        with spatial_context(mesh, _height(x, mesh)), (
                tf32_off() if dtype == torch.float32
                else contextlib.nullcontext()):
            sem_probs, sem_mask, budget, score, partials = model.infer_prep(
                Predictor._standardize(x), max_instances=max_instances)
            idmap, counts, _, rounds = model.decoder.extract_rounds(
                sem_mask, score, partials, max_instances=max_instances,
                count_budget=budget, n_rounds=n_rounds,
                stop_params=stop_params)
        fn.rounds_run += rounds
        return sem_probs.float(), idmap.to(torch.int32), counts.to(torch.int32)

    fn.rounds_run = 0
    return fn


def make_train_spatial(cfg, model, mesh: Mesh, **step_kw):
    """Training step with the image rows over the ranks: ``step(state,
    batch, generator) -> (state, metrics)``, the step of
    ``runtime/train.py::make_train_step`` run on this rank's rows of the
    global batch (``shard_train_batch``).  The state is replicated
    (``replicate_state`` once first); each rank's backward holds its rows'
    share of the gradients, which are averaged over the ranks once a step
    (every rank computes the whole image's loss, so each share is the
    gradient times the ranks); the loss and the metrics are the whole
    image's.  Every rank's generator draws the same numbers."""
    from tpuseg_torch.runtime.train import make_train_step

    step = make_train_step(cfg, model, **step_kw)

    def fn(state, batch, generator):
        local = shard_train_batch(batch, mesh)
        with spatial_context(mesh, _height(local["images"], mesh)):
            return step(state, local, generator)

    return fn
