"""IO layer of the port: URIs, streams, the virtual filesystems (local,
HTTP, S3, GCS, Azure, WebHDFS), RecordIO, integrity and the input
splits (text, RecordIO, indexed RecordIO, stdin; the prefetching,
cached and shuffled wrappers) (the port of ``dmlc_tpu/io``)."""

from .stream import (  # noqa: F401
    FileStream,
    MemoryBytesStream,
    MemoryFixedSizeStream,
    SeekStream,
    Serializable,
    Stream,
)
from .uri import URI, URISpec  # noqa: F401
from .filesys import FileInfo, FileSystem, register_filesystem  # noqa: F401
from .recordio import (  # noqa: F401
    KMAGIC,
    RecordIOChunkReader,
    RecordIOReader,
    RecordIOWriter,
)
from . import input_split  # noqa: F401
from .input_split import (  # noqa: F401
    IndexedRecordIOSplitter,
    InputSplit,
    InputSplitBase,
    LineSplitter,
    RecordIOSplitter,
    SingleFileSplit,
)
from .input_split_shuffle import InputSplitShuffle, create_shuffled  # noqa: F401
from .threaded_input_split import ThreadedInputSplit  # noqa: F401
from .cached_input_split import CachedInputSplit  # noqa: F401
