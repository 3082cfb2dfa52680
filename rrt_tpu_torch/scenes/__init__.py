"""Canned scenes. Each builder returns (SceneArrays, Camera)."""

from .book1 import (book2chap2_scene, chap11_scene, chap12_scene,
                    diffuse_scene)
from .book2 import (cornell_box_scene, cornell_smoke_scene, earth_scene,
                    rttnw_final_scene, simple_light_scene)

SCENES = {
    "diffuse": diffuse_scene,
    "chap11": chap11_scene,
    "chap12": chap12_scene,
    "book2chap2": book2chap2_scene,
    "cornell": cornell_box_scene,
    "cornell_smoke": cornell_smoke_scene,
    "simple_light": simple_light_scene,
    "earth": earth_scene,
    "rttnw_final": rttnw_final_scene,
}
