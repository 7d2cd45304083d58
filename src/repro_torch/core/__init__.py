"""Click models, parameterizations, recursions and metrics (port of
``repro.core``)."""
from repro_torch.core.base import (ClickModel, clicks_before,
                                   last_click_positions, masked_mean,
                                   validate_batch)
from repro_torch.core.metrics import (ConditionalPerplexity, LogLikelihood,
                                      MultiMetric, Perplexity, RaxMetric,
                                      average_precision_metric, dcg_metric,
                                      mrr_metric, ndcg_metric)
from repro_torch.core.models import (MODEL_REGISTRY, CascadeModel,
                                     ClickChainModel, DependentClickModel,
                                     DocumentCTR, DynamicBayesianNetwork,
                                     GlobalCTR, MixtureModel,
                                     PositionBasedModel, RankCTR,
                                     SimplifiedDBN, UserBrowsingModel)
from repro_torch.core.parameterization import (Combination, Compression,
                                               DeepCrossParameterConfig,
                                               EmbeddingParameter,
                                               EmbeddingParameterConfig,
                                               FeatureParameter,
                                               LinearParameterConfig,
                                               MLPParameterConfig,
                                               PositionParameter,
                                               ScalarParameter,
                                               ScalarParameterConfig,
                                               UBMExaminationParameter,
                                               build_parameter, hash_ids)

__all__ = [
    "ClickModel", "clicks_before", "last_click_positions", "masked_mean",
    "validate_batch", "ConditionalPerplexity", "LogLikelihood",
    "MultiMetric", "Perplexity", "RaxMetric", "average_precision_metric",
    "dcg_metric", "mrr_metric", "ndcg_metric",
    "MODEL_REGISTRY", "CascadeModel", "ClickChainModel",
    "DependentClickModel", "DocumentCTR", "DynamicBayesianNetwork",
    "GlobalCTR", "MixtureModel", "PositionBasedModel", "RankCTR",
    "SimplifiedDBN", "UserBrowsingModel", "Combination", "Compression",
    "DeepCrossParameterConfig", "EmbeddingParameter",
    "EmbeddingParameterConfig", "FeatureParameter", "LinearParameterConfig",
    "MLPParameterConfig", "PositionParameter", "ScalarParameter",
    "ScalarParameterConfig", "UBMExaminationParameter", "build_parameter",
    "hash_ids",
]
