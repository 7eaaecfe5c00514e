"""Data layer: sparse RowBlocks, classic-ML text parsers, row iterators
(the port of ``dmlc_tpu/data``)."""

from .row_block import Row, RowBlock, RowBlockContainer, index_t, real_t  # noqa: F401
from .parser import (  # noqa: F401
    Parser,
    TextParserBase,
    ThreadedParser,
    create_parser,
    register_parser,
)
from .text_parsers import (  # noqa: F401
    CSVParser,
    CSVParserParam,
    LibFMParser,
    LibSVMParser,
)
from .row_iter import (  # noqa: F401
    BasicRowIter,
    DiskRowIter,
    RowBlockIter,
    create_row_iter,
)
