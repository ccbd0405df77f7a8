"""Obstacle and volume I/O: copies of fluidnet_tpu.io's backend-free
modules (binvox import and export, the OBJ voxelizer, .vbox export, voxel
placement, obstacle OBJ export); the binvox decoder and the voxelizer's
solid fill run in fluidnet_tpu_torch.native, NumPy without it."""

from fluidnet_tpu_torch.io import voxel_utils
from fluidnet_tpu_torch.io.binvox import load_binvox
from fluidnet_tpu_torch.io.obj_export import export_obstacles_obj
from fluidnet_tpu_torch.io.vbox import VboxWriter, read_vbox
