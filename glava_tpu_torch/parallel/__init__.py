"""Many streams on one card: the batched and mixed-module renderers."""

from glava_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedRenderer, MixedBatchedRenderer, example_batch,
)
