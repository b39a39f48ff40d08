"""Serving tier of the port: static KV cache, generation engine, the
continuous-batching scheduler and the encoders' bucketed scorer
(``paddle_tpu/serving``)."""
from .draft import DraftProposer, NgramProposer  # noqa: F401
from .engine import EncoderScorer, GenerationEngine  # noqa: F401
from .kv_cache import (  # noqa: F401
    MASK_MIN,
    ChunkView,
    DecodeView,
    KVCache,
    PrefillView,
    default_buckets,
    pick_bucket,
)
from .scheduler import (FINISH_REASONS, CostAwareAdmission,  # noqa: F401
                        Request, Scheduler, default_slo_monitor)
