"""Volume data model: voxel formats, DICOM-style windowing, volume metadata
(PyTorch port).

Counterpart of `tbraymarcherplugin_tpu/utils/volume_info.py`, after the
reference's `VolumeInfo.h:13-151`: ``EVolumeVoxelFormat`` ->
:class:`VoxelFormat`, ``FWindowingParameters`` -> :class:`WindowingParameters`,
``FVolumeInfo`` -> :class:`VolumeInfo`; normalize/denormalize follow
`VolumeInfo.cpp:18-55`. Everything here is host-side numpy and Python
numbers; :meth:`WindowingParameters.as_vec4` packs the window into a tensor
on the device the caller names.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from .device import to_device


class VoxelFormat(enum.Enum):
    """Voxel storage format of a loaded volume (`VolumeInfo.h:13-27`)."""

    UINT8 = "uint8"
    INT8 = "int8"
    UINT16 = "uint16"
    INT16 = "int16"
    UINT32 = "uint32"
    INT32 = "int32"
    FLOAT32 = "float32"

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.value)

    @property
    def byte_size(self) -> int:
        return self.dtype.itemsize

    @property
    def is_signed(self) -> bool:
        return self.dtype.kind in ("i", "f")

    @classmethod
    def from_dtype(cls, dt) -> "VoxelFormat":
        return cls(np.dtype(dt).name)


# MHD `ElementType` tag values -> VoxelFormat (`MHDLoader.cpp:18-181`).
MET_TYPE_TO_FORMAT = {
    "MET_UCHAR": VoxelFormat.UINT8,
    "MET_CHAR": VoxelFormat.INT8,
    "MET_USHORT": VoxelFormat.UINT16,
    "MET_SHORT": VoxelFormat.INT16,
    "MET_UINT": VoxelFormat.UINT32,
    "MET_INT": VoxelFormat.INT32,
    "MET_FLOAT": VoxelFormat.FLOAT32,
}
FORMAT_TO_MET_TYPE = {v: k for k, v in MET_TYPE_TO_FORMAT.items()}


@dataclasses.dataclass
class WindowingParameters:
    """Window center/width plus low/high cutoff flags, in normalized volume
    units (`VolumeInfo.h:31-53` of the reference)."""

    center: float = 0.5
    width: float = 1.0
    low_cutoff: bool = True
    high_cutoff: bool = True

    def as_vec4(self, device=None) -> torch.Tensor:
        """(center, width, low, high) as float32, like `ToLinearColor`."""
        return to_device(
            [float(self.center), float(self.width),
             1.0 if self.low_cutoff else 0.0,
             1.0 if self.high_cutoff else 0.0],
            device, torch.float32,
        )


@dataclasses.dataclass
class VolumeInfo:
    """Metadata describing a loaded volume (`VolumeInfo.h:56-151`).

    ``dimensions`` is (X, Y, Z) in voxels, and arrays holding the data have
    that shape, so UVW coordinates map onto array axes. ``spacing`` is mm
    per voxel; ``world_dimensions = dimensions * spacing``.
    """

    data_file_name: str = ""
    original_format: VoxelFormat = VoxelFormat.UINT8
    actual_format: VoxelFormat = VoxelFormat.UINT8
    dimensions: Tuple[int, int, int] = (0, 0, 0)
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    default_windowing: WindowingParameters = dataclasses.field(
        default_factory=WindowingParameters
    )
    is_normalized: bool = False
    min_value: float = -1000.0
    max_value: float = 3000.0
    is_compressed: bool = False
    compressed_byte_size: int = 0
    parse_successful: bool = True
    # filled by DICOM loading (`VolumeInfo.h:123-126`)
    min_slice_number: int | None = None
    max_slice_number: int | None = None

    @property
    def world_dimensions(self) -> Tuple[float, float, float]:
        return tuple(d * s for d, s in zip(self.dimensions, self.spacing))

    @property
    def total_voxels(self) -> int:
        x, y, z = self.dimensions
        return x * y * z

    @property
    def byte_size(self) -> int:
        return self.total_voxels * self.actual_format.byte_size

    # --- normalize/denormalize round trip (`VolumeInfo.cpp:18-55`) ---------

    def normalize_value(self, value):
        """Map a raw data value from [min, max] to [0, 1] (may leave it)."""
        return (value - self.min_value) / (self.max_value - self.min_value)

    def denormalize_value(self, value):
        """Map a [0, 1] value back to the original [min, max] range."""
        return value * (self.max_value - self.min_value) + self.min_value

    def normalize_range(self, rng):
        """Scale a range (a width) into normalized units."""
        return rng / (self.max_value - self.min_value)

    def denormalize_range(self, rng):
        """Scale a normalized range back to data units."""
        return rng * (self.max_value - self.min_value)

    def update_min_max_slice_number(self, slice_number: int) -> None:
        if self.min_slice_number is None or slice_number < self.min_slice_number:
            self.min_slice_number = slice_number
        if self.max_slice_number is None or slice_number > self.max_slice_number:
            self.max_slice_number = slice_number

    def __str__(self) -> str:
        return (
            f"VolumeInfo(file={self.data_file_name!r}, dims={self.dimensions}, "
            f"spacing={self.spacing}, fmt={self.actual_format.value}, "
            f"normalized={self.is_normalized}, "
            f"range=[{self.min_value}, {self.max_value}])"
        )


def normalize_array(
    data: np.ndarray, out_format: VoxelFormat | None = None
) -> tuple[np.ndarray, float, float]:
    """Min/max-normalize raw voxel data: (normalized, min, max).

    As `ConvertArrayToNormalizedArray` (`TextureUtilities.h:103-149`): scan
    min/max and map onto the full range of the integer format (u8/u16), so
    the original values come back through the min/max kept in
    :class:`VolumeInfo`; float32 in [0, 1] when ``out_format`` is None.
    """
    data = np.asarray(data)
    lo = float(data.min()) if data.size else 0.0
    hi = float(data.max()) if data.size else 1.0
    scale = hi - lo
    if scale == 0.0:
        norm = np.zeros_like(data, dtype=np.float32)
    else:
        norm = (data.astype(np.float32) - lo) / scale
    if out_format is None or out_format == VoxelFormat.FLOAT32:
        return norm.astype(np.float32), lo, hi
    if out_format == VoxelFormat.UINT8:
        return np.round(norm * 255.0).astype(np.uint8), lo, hi
    if out_format == VoxelFormat.UINT16:
        return np.round(norm * 65535.0).astype(np.uint16), lo, hi
    raise ValueError(f"unsupported normalization target {out_format}")


def to_normalized_float(data: np.ndarray, fmt: VoxelFormat) -> np.ndarray:
    """Stored voxel data as float32 texture-sampling units: integer volumes
    as normalized texture formats (UNORM u8 -> /255, u16 -> /65535; signed
    ones SNORM, clipped to [-1, 1]); float volumes pass through."""
    data = np.asarray(data)
    if fmt == VoxelFormat.FLOAT32:
        return data.astype(np.float32)
    info = np.iinfo(fmt.dtype)
    if fmt.is_signed:
        return np.clip(data.astype(np.float32) / info.max, -1.0, 1.0)
    return data.astype(np.float32) / info.max
