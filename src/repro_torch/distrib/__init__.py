"""Distributed training support (port of part of ``repro.distrib``): so far
the int8 quantization of :mod:`repro_torch.distrib.compression`, which the
serving registry's int8 tier uses. The compressed all-reduce and the mesh
wait for the distributed slice."""
from repro_torch.distrib.compression import (QuantizedTensor,
                                             dequantize_int8,
                                             dequantize_tree, quantize_int8,
                                             quantize_tree, tree_nbytes)

__all__ = ["QuantizedTensor", "quantize_int8", "dequantize_int8",
           "quantize_tree", "dequantize_tree", "tree_nbytes"]
