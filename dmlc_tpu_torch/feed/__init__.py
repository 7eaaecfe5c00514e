"""The device feed of the port (the port of ``dmlc_tpu/feed``)."""

from .autotune import FeedAutotuner  # noqa: F401
from .device_feed import (  # noqa: F401
    DeviceFeed,
    libsvm_feed,
    pack_rowblock,
    pack_rowblock_plain,
    recordio_feed,
    recordio_packed_feed,
)
