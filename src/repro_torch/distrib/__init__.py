"""Distribution layer (port of ``repro.distrib``): sharding rules, the
sharded lookups' collectives, and gradient compression."""
from repro_torch.distrib.shardings import (
    batch_spec,
    table_spec,
    replicated_spec,
    make_shardings,
    DATA_AXES,
    MODEL_AXIS,
)
from repro_torch.distrib.compression import (
    quantize_int8,
    dequantize_int8,
    quantize_tree,
    dequantize_tree,
    tree_nbytes,
    QuantizedTensor,
    CompressedAllReduce,
)
from repro_torch.distrib.collectives import (
    sharded_embedding_lookup,
    masked_psum_lookup,
)

__all__ = [
    "batch_spec",
    "table_spec",
    "replicated_spec",
    "make_shardings",
    "DATA_AXES",
    "MODEL_AXIS",
    "quantize_int8",
    "dequantize_int8",
    "quantize_tree",
    "dequantize_tree",
    "tree_nbytes",
    "QuantizedTensor",
    "CompressedAllReduce",
    "sharded_embedding_lookup",
    "masked_psum_lookup",
]
