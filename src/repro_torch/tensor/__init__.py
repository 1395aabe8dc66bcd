"""Block-sparse tensor substrate on torch blocks."""
from .qn import Charge, IN, Index, OUT, fuse_sectors, make_index, qadd, qneg, qzero
from .blocksparse import BlockSparseTensor, contract, flip_flow, svd_split
from .block_csr import contract_block_csr

__all__ = [
    "Charge", "IN", "Index", "OUT", "fuse_sectors", "make_index", "qadd",
    "qneg", "qzero", "BlockSparseTensor", "contract", "flip_flow",
    "svd_split", "contract_block_csr",
]
