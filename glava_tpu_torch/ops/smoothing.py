"""Log-frequency resampling (``smooth_audio``) as precomputed operators.

The reference samples its spectrum textures through a GLSL function
``smooth_audio`` (shaders/glava/util/smooth.glsl:23-64): each output
position ``idx in [0, 1]`` maps through a log curve to a source span
``[smin, smax]`` whose texels are combined with a distance-weighted
kernel (``average`` / ``maximum`` / ``hybrid`` modes, weight curves
from util/common.glsl). By default a dedicated 1-D "smooth pass"
(util/smooth_pass.frag, dispatched at render.c:2276-2303) precomputes
``smooth_audio`` for every texel so module shaders can fetch directly.

The span boundaries and kernel weights depend only on static
configuration (texture size, SMOOTH factor, SAMPLE_* knobs), so they
are baked host-side in numpy, exactly as the JAX package bakes them
(the baked operators are bit-identical between the two packages):

* ``average`` mode becomes a single (P, sz) matmul, or its block-banded
  form at large sizes;
* ``maximum``/``hybrid`` use a padded (P, K) gather + weighted max.

:class:`ResampleOp` holds the numpy weights; :meth:`ResampleOp.on`
moves them to a device once, as a :class:`DeviceResample` that applies
them to torch tensors (``torch.matmul``/``einsum``: a plain matrix
product, as the JAX package left it to XLA).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Literal, NamedTuple

import numpy as np
import torch

from glava_tpu_torch.ops.windows import ROUND_FORMULAS

SampleMode = Literal["average", "maximum", "hybrid"]


def scale_audio(idx, sample_range: float, sample_scale: float):
    """smooth.glsl:13-15: ``-log(1 - SAMPLE_RANGE*idx) / SAMPLE_SCALE``."""
    idx = np.asarray(idx, dtype=np.float64)
    return -np.log(-(sample_range * idx) + 1.0) / sample_scale


class SmoothParams(NamedTuple):
    """Static knobs of the smoothing kernel.

    Defaults match shaders/glava/smooth_parameters.glsl and the
    renderer defaults (render.c:916, smooth_factor 0.025).
    """

    factor: float = 0.025          # _SMOOTH_FACTOR (setsmoothfactor)
    sample_mode: SampleMode = "average"  # SAMPLE_MODE
    hybrid_weight: float = 0.65    # SAMPLE_HYBRID_WEIGHT
    sample_scale: float = 8.0      # SAMPLE_SCALE
    sample_range: float = 0.9      # SAMPLE_RANGE
    round_formula: str = "sinusoidal"  # ROUND_FORMULA


class Banded(NamedTuple):
    """Block-banded form of an average-mode resample matrix.

    Each row's kernel only touches a CONTIGUOUS source window, and
    windows drift monotonically with the output position — so blocks
    of R consecutive rows share a padded window of Kb columns and the
    whole operator is ONE batched (B, R, Kb) x (..., B, Kb) einsum.
    At bufsize 16384 this is ~4.4x smaller than the dense matrix and
    takes proportionally fewer FLOPs."""

    starts: np.ndarray   # (B,) first source column per block
    blocks: np.ndarray   # (B, R, Kb) f32 weights
    n_out: int           # valid output rows (B*R may overshoot)


def _make_banded(mat: np.ndarray, tile: int = 128) -> Banded:
    """Block-banded decomposition of a dense (P, S) kernel matrix whose
    rows have contiguous support. Kb is the max per-block window width
    rounded up to the 128-lane grid; apply() pads the source by Kb so
    clamping start offsets is never needed."""
    P, S = mat.shape
    B = -(-P // tile)
    padded = np.zeros((B * tile, S), np.float32)
    padded[:P] = mat
    starts, widths = [], []
    for b in range(B):
        blk = padded[b * tile:(b + 1) * tile]
        nz = np.nonzero(blk.any(axis=0))[0]
        c0 = int(nz[0]) if nz.size else 0
        c1 = int(nz[-1]) + 1 if nz.size else 1
        starts.append(c0)
        widths.append(c1 - c0)
    Kb = -(-max(widths) // 128) * 128
    blocks = np.zeros((B, tile, Kb), np.float32)
    for b, c0 in enumerate(starts):
        blk = padded[b * tile:(b + 1) * tile]
        wdt = min(Kb, S - c0)
        blocks[b, :, :wdt] = blk[:, c0:c0 + wdt]
    return Banded(np.asarray(starts, np.int64), blocks, P)


class ResampleOp(NamedTuple):
    """Baked smooth_audio evaluated at P static positions (numpy)."""

    mode: str
    # average mode: dense (P, sz) weight matrix (rows already normalized)
    matrix: np.ndarray | None
    # maximum/hybrid: (P, K) texel indices and kernel weights (w=0 padding)
    idx: np.ndarray | None
    w: np.ndarray | None
    hybrid_weight: float
    # average mode at large sizes: block-banded forms of `matrix` and
    # of its even/odd column split (None = use the dense matmul)
    banded: Banded | None = None
    banded_re: Banded | None = None
    banded_im: Banded | None = None

    def on(self, device) -> "DeviceResample":
        """The same operator with its weights on ``device``."""
        return DeviceResample(self, torch.device(device))


class _DeviceBanded:
    """A :class:`Banded` operator on one device."""

    def __init__(self, b: Banded, device: torch.device):
        nb, _, kb = b.blocks.shape
        self.blocks = torch.as_tensor(b.blocks, device=device)
        # (B, Kb) source column of every window entry
        self.cols = (torch.as_tensor(b.starts, device=device)[:, None]
                     + torch.arange(kb, device=device))
        self.kb = kb
        self.n_out = b.n_out

    def __call__(self, vec: torch.Tensor) -> torch.Tensor:
        nb, r, _ = self.blocks.shape
        wins = torch.nn.functional.pad(vec, (0, self.kb))[..., self.cols]
        out = torch.einsum("brk,...bk->...br", self.blocks, wins)
        return out.reshape(*out.shape[:-2], nb * r)[..., : self.n_out]


class DeviceResample:
    """A :class:`ResampleOp` whose weights live on one device."""

    def __init__(self, op: ResampleOp, device: torch.device):
        self.mode = op.mode
        self.hybrid_weight = op.hybrid_weight
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        if op.mode == "average":
            self.banded = None
            if op.banded is not None:
                self.banded = _DeviceBanded(op.banded, device)
                self.banded_re = _DeviceBanded(op.banded_re, device)
                self.banded_im = _DeviceBanded(op.banded_im, device)
                return
            # the log curve only ever samples the leading band of the
            # spectrum (scale_audio(1) * sz texels); the matrix is
            # stored column-cropped to that band
            m = op.matrix
            self.band = m.shape[1]
            self.mat_t = t(np.ascontiguousarray(m.T))            # (S, P)
            self.wre_t = t(np.ascontiguousarray(m[:, 0::2].T))
            self.wim_t = t(np.ascontiguousarray(m[:, 1::2].T))
            return
        self.idx = t(op.idx.astype(np.int64))
        self.w = t(op.w)
        self.half = self.idx // 2
        self.even = self.idx % 2 == 0
        self.wsum = torch.clamp_min(self.w.sum(dim=-1),
                                    torch.finfo(torch.float32).tiny)

    def _pool(self, vals: torch.Tensor) -> torch.Tensor:
        vals = vals * self.w                                    # (..., P, K)
        vmax = vals.amax(dim=-1)
        if self.mode == "maximum":
            return vmax
        hw = self.hybrid_weight
        return vmax * (1.0 - hw) + vals.sum(dim=-1) / self.wsum * hw

    def __call__(self, tex: torch.Tensor) -> torch.Tensor:
        """Apply to (..., sz) spectrum planes -> (..., P)."""
        if self.mode == "average":
            if self.banded is not None:
                return self.banded(tex)
            return torch.matmul(tex[..., : self.band], self.mat_t)
        return self._pool(tex[..., self.idx])

    def apply_planes(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """Apply directly to (..., m) complex planes of the interleaved
        spectrum (tex[2k] = re[k], tex[2k+1] = im[k]) without
        materializing the interleaved layout: the average matrix splits
        by column parity into two plane matmuls."""
        if self.mode == "average":
            if self.banded is not None:
                return self.banded_re(re) + self.banded_im(im)
            return (torch.matmul(re[..., : (self.band + 1) // 2], self.wre_t)
                    + torch.matmul(im[..., : self.band // 2], self.wim_t))
        vals = torch.where(self.even, re[..., self.half], im[..., self.half])
        return self._pool(vals)


def _span(tex_sz: int, idx: float, p: SmoothParams) -> tuple[float, float]:
    smin = scale_audio(min(max(idx - p.factor, 0.0), 1.0), p.sample_range, p.sample_scale) * tex_sz
    smax = scale_audio(min(max(idx + p.factor, 0.0), 1.0), p.sample_range, p.sample_scale) * tex_sz
    return float(smin), float(smax)


def build_resample(tex_sz: int, positions, params: SmoothParams,
                   banded: bool | None = None) -> ResampleOp:
    """Bake ``smooth_audio(tex, tex_sz, idx)`` for each static position.

    Mirrors smooth.glsl:23-64: the sample loop steps ``s`` from ``smin``
    by 1.0 (inclusive of ``smax`` in average mode, exclusive in
    maximum/hybrid), fetches texel ``round(s)`` and weights it with
    ``ROUND_FORMULA(clamp((m - |rm - s|) / m, 0, 1))``. ``banded``
    forces the average-mode form (None: the size heuristic).
    """
    positions = np.asarray(positions, dtype=np.float64).ravel()
    formula = ROUND_FORMULAS[params.round_formula]
    P = positions.shape[0]

    rows: list[tuple[np.ndarray, np.ndarray]] = []  # (texel indices, weights)
    inclusive = params.sample_mode == "average"
    for idx in positions:
        smin, smax = _span(tex_sz, float(idx), params)
        m = (smax - smin) / 2.0
        rm = smin + m
        if inclusive:
            count = int(math.floor(smax - smin)) + 1 if smax >= smin else 0
        else:
            count = int(math.ceil(smax - smin)) if smax > smin else 0
            # float loop `for (s = smin; s < smax; s += 1)` runs
            # ceil(smax - smin) times (smax strictly greater).
        s = smin + np.arange(max(count, 0), dtype=np.float64)
        if m > 0:
            wraw = np.clip((m - np.abs(rm - s)) / m, 0.0, 1.0)
        else:
            wraw = np.ones_like(s)
        w = formula(wraw)
        texel = np.clip(np.round(s).astype(np.int64), 0, tex_sz - 1)
        rows.append((texel, np.asarray(w, dtype=np.float64)))

    if params.sample_mode == "average":
        mat = np.zeros((P, tex_sz), dtype=np.float32)
        for r, (texel, w) in enumerate(rows):
            total = w.sum()
            if total <= 0:
                continue
            np.add.at(mat[r], texel, (w / total).astype(np.float32))
        # crop trailing all-zero columns (pad to the 128-lane grid)
        nz = np.nonzero(mat.any(axis=0))[0]
        band = int(nz[-1]) + 1 if nz.size else tex_sz
        band = min(-(-band // 128) * 128, tex_sz)
        mat = np.ascontiguousarray(mat[:, :band])
        # large kernels go block-banded: same weights, a fraction of
        # the storage and FLOPs. Size heuristic (the JAX package's,
        # without its TPU wisdom lookup): band > 2048, OR the dense
        # matrix is big (>= 8 MB) and banding shrinks it >= 2x.
        tile = 128
        cand = None
        if banded is not None:       # explicit caller override
            use_banded = banded
        else:
            use_banded = band > 2048
            if not use_banded and mat.nbytes >= (8 << 20):
                cand = _make_banded(mat, tile=tile)
                use_banded = cand.blocks.nbytes * 2 <= mat.nbytes
                if not use_banded:
                    cand = None
        if use_banded:
            banded = cand if cand is not None else _make_banded(mat, tile=tile)
            banded_re = _make_banded(
                np.ascontiguousarray(mat[:, 0::2]), tile=tile)
            banded_im = _make_banded(
                np.ascontiguousarray(mat[:, 1::2]), tile=tile)
            return ResampleOp("average", None, None, None,
                              params.hybrid_weight, banded,
                              banded_re, banded_im)
        return ResampleOp("average", mat, None, None, params.hybrid_weight)

    K = max((len(t) for t, _ in rows), default=1) or 1
    idx_arr = np.zeros((P, K), dtype=np.int32)
    w_arr = np.zeros((P, K), dtype=np.float32)
    for r, (texel, w) in enumerate(rows):
        idx_arr[r, : len(texel)] = texel
        w_arr[r, : len(texel)] = w
    return ResampleOp(
        params.sample_mode, None, idx_arr, w_arr, params.hybrid_weight
    )


@lru_cache(maxsize=None)
def presmooth_op(tex_sz: int, params: SmoothParams) -> ResampleOp:
    """The default smooth *pass* operator (util/smooth_pass.frag).

    Resamples a spectrum onto itself: output texel ``i`` is
    ``smooth_audio(tex, tex_sz, i / tex_sz)`` (fragment x / target
    width). Module rasterizers then fetch pre-smoothed texels directly
    (_PRE_SMOOTHED_AUDIO branch, smooth.glsl:61-63).
    """
    pos = np.arange(tex_sz, dtype=np.float64) / tex_sz
    return build_resample(tex_sz, pos, params)
