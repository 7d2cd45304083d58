"""Click models, parameterizations, recursions and metrics (port of the
training slice of ``repro.core``)."""
from repro_torch.core.base import ClickModel, masked_mean, validate_batch
from repro_torch.core.metrics import (ConditionalPerplexity, LogLikelihood,
                                      MultiMetric, Perplexity)
from repro_torch.core.models import (MODEL_REGISTRY, ClickChainModel,
                                     DependentClickModel, DocumentCTR,
                                     DynamicBayesianNetwork, GlobalCTR,
                                     RankCTR, SimplifiedDBN)
from repro_torch.core.parameterization import (Compression,
                                               EmbeddingParameter,
                                               EmbeddingParameterConfig,
                                               PositionParameter,
                                               ScalarParameter,
                                               ScalarParameterConfig,
                                               build_parameter, hash_ids)

__all__ = [
    "ClickModel", "masked_mean", "validate_batch", "ConditionalPerplexity",
    "LogLikelihood", "MultiMetric", "Perplexity", "MODEL_REGISTRY",
    "ClickChainModel", "DependentClickModel", "DocumentCTR",
    "DynamicBayesianNetwork", "GlobalCTR", "RankCTR", "SimplifiedDBN",
    "Compression", "EmbeddingParameter", "EmbeddingParameterConfig",
    "PositionParameter", "ScalarParameter", "ScalarParameterConfig",
    "build_parameter", "hash_ids",
]
