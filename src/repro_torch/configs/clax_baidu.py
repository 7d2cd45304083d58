"""The paper's own workload: CLAX click models at Baidu-ULTR scale.

Port of the model builder of ``repro.configs.clax_baidu`` (``_make_model``):
2^31 query-document ids hashed 10x down, with baseline correction, giving a
214,748,672-row float32 logit table (0.86 GB) per hashed variable. The DBN
has separate attraction and satisfaction tables of that size; DCTR, which
the port trains on the same width to drive the ``session_nll`` kernel, has
the attraction table alone. The UBM variant waits for UBM's port.
"""
from __future__ import annotations

from repro_torch.core import (Compression, DocumentCTR,
                              DynamicBayesianNetwork, EmbeddingParameterConfig)

POSITIONS = 10
TRAIN_BATCH = 65536


def make_model(kind: str = "dbn", device="cuda"):
    """The paper-width DBN (``kind="dbn"``) or DCTR (``kind="dctr"``)."""
    cfg = EmbeddingParameterConfig(
        parameters=1 << 31, compression=Compression.HASH,
        compression_ratio=10.0, baseline_correction=True, init_logit=-2.0)
    if kind == "dbn":
        return DynamicBayesianNetwork(positions=POSITIONS, attraction=cfg,
                                      satisfaction=cfg, device=device)
    if kind == "dctr":
        return DocumentCTR(positions=POSITIONS, attraction=cfg, device=device)
    raise ValueError(f"no paper-width {kind!r} in the port (dbn, dctr)")
