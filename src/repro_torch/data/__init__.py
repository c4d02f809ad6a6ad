from repro_torch.data.packing import pack_documents, packing_labels
from repro_torch.data.pipeline import Scattered, ShardedLoader, rank0_scatter
from repro_torch.data.synthetic import (PAPER_DATASET_SHAPES, Dataset,
                                        make_batch, make_dataset,
                                        synthetic_tokens)

__all__ = ["PAPER_DATASET_SHAPES", "Dataset", "Scattered", "ShardedLoader",
           "make_batch", "make_dataset", "pack_documents",
           "packing_labels", "rank0_scatter", "synthetic_tokens"]
