"""Many streams on one card or sharded over several: the batched,
mixed-module and sharded renderers, and the device mesh."""

from glava_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer, example_batch,
)
from glava_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
