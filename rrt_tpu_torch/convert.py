"""Carry scene and camera state across from the JAX package.

`rrt_tpu`'s SceneArrays and Camera are dataclasses of arrays; handed
over as dictionaries of numpy arrays (field name -> value), they become
the port's objects here without this package importing JAX:

    leaves = {f.name: np.asarray(getattr(scene, f.name))
              for f in dataclasses.fields(scene)}
    scene_t = scene_from_numpy(leaves)

and back: `camera_to_numpy`, and `params_from_numpy` /
`params_to_numpy` for diff.partition() dicts and their gradients.
"""

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .scene import SceneArrays, tensor_fields


def scene_from_numpy(leaves: dict) -> SceneArrays:
    """SceneArrays from a field-name -> numpy-array dictionary holding
    every SceneArrays field (static flags as bools or 0-d arrays)."""
    arrays = set(tensor_fields())
    kwargs = {}
    for f in dataclasses.fields(SceneArrays):
        v = leaves[f.name]
        if f.name in arrays:
            kwargs[f.name] = torch.from_numpy(np.array(v))
        else:
            kwargs[f.name] = f.type(np.asarray(v).item())
    return SceneArrays(**kwargs)


def camera_from_numpy(leaves: dict) -> Camera:
    """Camera from a field-name -> numpy-array dictionary."""
    return Camera(**{
        f.name: torch.from_numpy(np.array(leaves[f.name], np.float32))
        for f in dataclasses.fields(Camera)})


def camera_to_numpy(camera: Camera) -> dict:
    """The inverse of camera_from_numpy: field name -> numpy array."""
    return {f.name: getattr(camera, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(Camera)}


def params_from_numpy(leaves: dict) -> dict:
    """A diff.partition() dict (or a gradient of one) from a field-name
    -> numpy-array dictionary, as float32 tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in leaves.items()}


def params_to_numpy(params: dict) -> dict:
    """The inverse of params_from_numpy."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
