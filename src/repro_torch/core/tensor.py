"""TensorSpec with layout metadata — the unit the tiling optimizer reasons
about (paper §II-B: layout determines the memcpy pattern of a tiling).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "int32": 4, "fp8": 1}


@dataclass(frozen=True)
class TensorSpec:
    """shape with dimension tags, e.g. (1, 16, 16, 128) / "NHWC"."""
    shape: Tuple[int, ...]
    dims: str                     # one tag char per dim, e.g. "NHWC"
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return self.n_elems * _DTYPE_BYTES.get(self.dtype, 4)

    def dim(self, tag: str) -> int:
        return self.shape[self.dims.index(tag)]

    def with_dim(self, tag: str, size: int) -> "TensorSpec":
        s = list(self.shape)
        s[self.dims.index(tag)] = size
        return TensorSpec(tuple(s), self.dims, self.dtype)

    def contiguous_run(self, tile_shape: Sequence[int]) -> int:
        """Elements of one maximal contiguous memcpy when extracting a tile
        of ``tile_shape`` from this (row-major) tensor.

        The run extends over the trailing dims that are NOT tiled (tile dim
        == full dim), times the tile size of the first tiled dim.
        """
        run = 1
        for full, tile in zip(reversed(self.shape), reversed(tuple(tile_shape))):
            if tile == full:
                run *= full
            else:
                run *= tile
                break
        return run

    def n_memcpys(self, tile_shape: Sequence[int]) -> int:
        """Number of contiguous memcpys to materialize ALL tiles (Fig 5/6)."""
        run = self.contiguous_run(tile_shape)
        return max(1, self.n_elems // run)
