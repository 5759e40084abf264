"""Device meshes for a fleet sharded over several cards.

The port of ``glava_tpu/parallel/mesh.py``: the same ``make_mesh``
defaults, axis names, shapes, validation and messages, over
``torch.device``s. Where JAX hands a mesh to XLA, which partitions one
program, the port runs one renderer a device
(``parallel.batch.ShardedRenderer``) over its (stream block, row band):
the streams split into contiguous, equal blocks over the stream axes,
as ``P(stream_axes)`` splits the leading axis in JAX, and the frame's
row axis (axis 1 of (S, H, W, 4), row 0 at the bottom) into ``rows``
contiguous, equal bands, as ``P(stream_axes, "rows")`` splits the
frames (``frame_sharding``).

* ``('streams', 'rows')``, or ``('hosts', 'streams', 'rows')`` with
  ``hosts``: in this one process the hosts axis is flattened with
  streams into stream shards (streams are independent, so no shard
  reads another's data, as the JAX fleet's zero-collective step).
* ``rows``: the devices of one row group (one stream shard) each hold
  their block's state, replicated as JAX replicates ``P(stream_axes)``
  state over rows, and advance it from the same audio; each renders
  its band. An H that ``rows`` does not divide raises ``ValueError``,
  as JAX's ``jit`` refuses the frame sharding.

One difference from JAX: a device may appear more than once (``["cpu"]
* 4``, ``["cuda:0", "cuda:0"]``), so that the CPU tests and a one-card
run drive several shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object ndarray of ``torch.device`` shaped by the
    axes; ``axis_names``: one name an axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _devices(devices) -> np.ndarray:
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices (for example ['cpu'] * 2)")
        devices = [f"cuda:{i}" for i in range(count)]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    out = np.empty(len(flat), dtype=object)
    for i, d in enumerate(flat):
        out[i] = torch.device(d)
    return out


def make_mesh(devices=None, *, streams: int | None = None,
              rows: int | None = None, hosts: int | None = None) -> Mesh:
    """Build a ('streams', 'rows') mesh over the given devices (by
    default every visible card, ``cuda:0 .. N-1``) or, with ``hosts``, a
    ('hosts', 'streams', 'rows') mesh. Defaults: all devices on the
    streams axis."""
    devices = _devices(devices)
    n = devices.size
    if hosts is not None:
        if hosts <= 0 or n % hosts:
            raise ValueError(
                f"need a device count divisible by hosts={hosts}, got {n}")
        per = n // hosts
        rows = rows or 1
        if per % rows:
            raise ValueError(
                f"per-host device count {per} not divisible by rows={rows}")
        streams = streams or per // rows
        if hosts * streams * rows != n:
            raise ValueError(
                f"mesh hosts={hosts} x streams={streams} x rows={rows} "
                f"needs {hosts * streams * rows} devices but {n} are "
                f"available")
        return Mesh(devices.reshape(hosts, streams, rows),
                    ("hosts", "streams", "rows"))
    if streams is None and rows is None:
        streams, rows = n, 1
    elif streams is None:
        if rows <= 0 or n % rows or n < rows:
            raise ValueError(
                f"need a device count divisible by rows={rows}, got {n} "
                f"device(s); provision more devices or lower rows"
            )
        streams = n // rows
    elif rows is None:
        if streams <= 0 or n % streams or n < streams:
            raise ValueError(
                f"need a device count divisible by streams={streams}, got "
                f"{n} device(s); provision more devices or lower streams"
            )
        rows = n // streams
    if streams * rows != n:
        raise ValueError(
            f"mesh streams={streams} x rows={rows} needs {streams * rows} "
            f"devices but {n} are available"
        )
    return Mesh(devices.reshape(streams, rows), ("streams", "rows"))


def stream_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the stream dimension shards over: ('hosts', 'streams')
    on a hosts mesh, else ('streams',)."""
    return tuple(a for a in mesh.axis_names if a in ("hosts", "streams"))


def shard_grid(mesh: Mesh) -> np.ndarray:
    """The (stream shard, row band) grid of devices: an object ndarray
    of shape (stream shards, rows), the stream axes flattened in mesh
    order (``mesh.devices.reshape(streams, rows)``); device [i, j]
    renders stream block i's band j."""
    return mesh.devices.reshape(-1, mesh.shape.get("rows", 1))


def row_bands(mesh: Mesh, height: int) -> list[tuple[int, int]]:
    """The rows [r0, r1) of each band of an H-row frame, in mesh order:
    ``rows`` contiguous, equal bands, as ``P(stream_axes, "rows")``
    splits axis 1 of the frames."""
    rows = mesh.shape.get("rows", 1)
    if height % rows:
        raise ValueError(
            f"a frame of height {height} does not split into rows={rows} "
            f"equal bands: the mesh's rows must divide H")
    per = height // rows
    return [(j * per, (j + 1) * per) for j in range(rows)]


def stream_slices(mesh: Mesh, n_streams: int) -> list[slice]:
    """The contiguous, equal block of streams each stream shard takes,
    as ``P(stream_axes)`` splits the leading axis."""
    shards = int(np.prod([mesh.shape[a] for a in stream_axes(mesh)]))
    if n_streams % shards:
        raise ValueError(
            f"{n_streams} streams do not split evenly over {shards} stream "
            f"shards of the mesh {mesh.shape}")
    per = n_streams // shards
    return [slice(i * per, (i + 1) * per) for i in range(shards)]
