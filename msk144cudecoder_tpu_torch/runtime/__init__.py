"""Host runtime: streaming shell, SNR tracking, result filtering, metrics.

Port of msk144cudecoder_tpu/runtime/: the compute path stays in ops/;
everything here is the host shell around the decode pipeline.
"""

from .decoder import StreamDecoder
from .metrics import ScopedMetric, SimpleTimer, metrics_enabled
from .result_filter import ResultFilter, ResultItem
from .snr import SNRTracker

__all__ = [
    "SNRTracker",
    "ResultFilter",
    "ResultItem",
    "SimpleTimer",
    "ScopedMetric",
    "metrics_enabled",
    "StreamDecoder",
]
