"""torchft_tpu_torch.semisync: the streaming semi-sync (DiLoCo) plane.

The counterpart of ``torchft_tpu/semisync``: the outer state fragmented on
the gradient plane's bucket planner, each fragment's pseudogradient round
streamed in the background of the inner steps over the striped ring, an
int8 (or int4) error-feedback wire codec whose encode runs on the card, and
an outer optimizer that applies only after the commit vote.

Layout:
  fragments.py  fragment planning (ddp.plan_buckets underneath)
  codec.py      int8 / int4 with error feedback, bf16, f32, auto
  engine.py     the background fragment-sync worker
  outer.py      the outer optimizer (optax's sgd, on tensor lists)
  diloco.py     StreamingDiLoCo
  metrics.py    the tpuft_semisync_* exposition

``torchft_tpu_torch.local_sgd.DiLoCo`` is the blocking wrapper over it.
"""

from torchft_tpu_torch.semisync.codec import (
    CODECS,
    TPUFT_SEMISYNC_CODEC_ENV,
    FragmentCodec,
    make_codec,
)
from torchft_tpu_torch.semisync.diloco import (
    TPUFT_SEMISYNC_FRAGMENT_COMMIT_ENV,
    TPUFT_SEMISYNC_STREAM_ENV,
    StreamingDiLoCo,
)
from torchft_tpu_torch.semisync.engine import SyncEngine
from torchft_tpu_torch.semisync.fragments import (
    DEFAULT_FRAGMENT_BYTES,
    TPUFT_SEMISYNC_FRAGMENT_BYTES_ENV,
    Fragment,
    FragmentPlan,
)
from torchft_tpu_torch.semisync.metrics import (
    TPUFT_SEMISYNC_METRICS_BIND_ENV,
    TPUFT_SEMISYNC_METRICS_PORT_ENV,
    SemiSyncMetrics,
)
from torchft_tpu_torch.semisync.outer import apply_updates, sgd

__all__ = [
    "StreamingDiLoCo",
    "SyncEngine",
    "Fragment",
    "FragmentPlan",
    "FragmentCodec",
    "make_codec",
    "SemiSyncMetrics",
    "sgd",
    "apply_updates",
    "CODECS",
    "DEFAULT_FRAGMENT_BYTES",
    "TPUFT_SEMISYNC_CODEC_ENV",
    "TPUFT_SEMISYNC_FRAGMENT_BYTES_ENV",
    "TPUFT_SEMISYNC_FRAGMENT_COMMIT_ENV",
    "TPUFT_SEMISYNC_STREAM_ENV",
    "TPUFT_SEMISYNC_METRICS_PORT_ENV",
    "TPUFT_SEMISYNC_METRICS_BIND_ENV",
]
