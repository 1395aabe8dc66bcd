"""PyTorch/CUDA port of the block-sparse DMRG reproduction.

Imports ``torch`` and numpy only.  Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
