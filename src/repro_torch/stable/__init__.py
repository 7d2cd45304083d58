"""Stable log-space primitives (port of ``repro.stable``)."""
from repro_torch.stable.logops import (MIN_LOG_PROB, absolute,
                                       exclusive_cumsum, log1m_sigmoid,
                                       log1mexp, log_add_exp, log_bce,
                                       log_cumsum, log_expm1, log_not, log_or,
                                       log_prob_to_logit, log_sigmoid,
                                       logit_to_log_prob, logsumexp, maximum,
                                       minimum, sigmoid_core, sigmoid_parts)

__all__ = [
    "MIN_LOG_PROB", "absolute", "exclusive_cumsum", "log1m_sigmoid",
    "log1mexp", "log_add_exp", "log_bce", "log_cumsum", "log_expm1",
    "log_not", "log_or", "log_prob_to_logit", "log_sigmoid",
    "logit_to_log_prob", "logsumexp", "maximum", "minimum", "sigmoid_core",
    "sigmoid_parts",
]
