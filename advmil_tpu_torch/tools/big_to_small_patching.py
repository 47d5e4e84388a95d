"""Expand level-L patch coordinates into the 4x4 grid of level-(L-1)
patches (counterpart of `advmil_tpu/tools/big_to_small_patching.py`).

Each big coordinate (x, y) of patch size P becomes the 16 coordinates
(x + i * P, y + j * P), i, j in 0..3, of the next finer level, so every
bag's patch count is a multiple of 16 and its patches form the 4x4 regions
that ESAT's embedding and the occlusion masking read. CLAM's `.h5`
coordinate files in, the same layout out (dataset `coords` with the level
attributes rescaled); `process_list_autogen.csv` is copied along.

    python -m advmil_tpu_torch.tools.big_to_small_patching READ_DIR SAVE_DIR
"""
from __future__ import annotations

import os
import os.path as osp
import shutil
import sys

import numpy as np

from ..utils.io import import_h5py


def get_scaled_matrix(width: int, height: int, scale: int = 4) -> np.ndarray:
    """[scale * scale, 2] offsets (i * width, j * height), row j major."""
    mat = np.zeros((scale, scale, 2))
    for j in range(scale):
        for i in range(scale):
            mat[j][i] = np.array([i * width, j * height])
    return mat.reshape(-1, 2)


def get_scaled_attrs(origin_attrs: dict, scale: int = 4) -> dict:
    return {
        "downsample": origin_attrs["downsample"] / scale,
        "downsampled_level_dim": origin_attrs["downsampled_level_dim"] * scale,
        "level_dim": origin_attrs["level_dim"] * scale,
        "name": origin_attrs["name"],
        "patch_level": origin_attrs["patch_level"] - 1,
        "patch_size": origin_attrs["patch_size"],
    }


def coords_big_to_small(path_in: str, path_out: str, patch_scale: int = 4):
    h5py = import_h5py(path_in)
    with h5py.File(path_in, "r") as hf:
        data_coords = hf["coords"]
        attrs = {k: data_coords.attrs[k] for k in data_coords.attrs.keys()}
        psize = data_coords.attrs["patch_size"]
        scaled_mat = get_scaled_matrix(psize, psize, patch_scale)
        coords = data_coords[:]
    scaled = (coords[:, None, :] + scaled_mat[None, :, :]).reshape(-1, 2).astype(np.int32)
    scaled_attrs = get_scaled_attrs(attrs, patch_scale)
    scaled_attrs["save_path"] = osp.dirname(path_out)
    with h5py.File(path_out, "w") as hf:
        dset = hf.create_dataset("coords", data=scaled, maxshape=(None, 2), chunks=(1, 2))
        for k, v in scaled_attrs.items():
            dset.attrs[k] = v


def process_coords(dir_read: str, dir_save: str):
    os.makedirs(dir_save, exist_ok=True)
    for fname in sorted(os.listdir(dir_read)):
        if not fname.endswith("h5"):
            print(f"invalid file {fname}, skipped")
            continue
        coords_big_to_small(osp.join(dir_read, fname), osp.join(dir_save, fname))
        print(f"expanded {fname}")
    record = osp.join(dir_read, "process_list_autogen.csv")
    if osp.exists(record):
        shutil.copy(record, dir_save)


if __name__ == "__main__":
    process_coords(sys.argv[1], sys.argv[2])
