"""Canned scenes. Each builder returns (SceneArrays, Camera)."""

from .book1 import chap11_scene, chap12_scene, diffuse_scene

SCENES = {
    "diffuse": diffuse_scene,
    "chap11": chap11_scene,
    "chap12": chap12_scene,
}
