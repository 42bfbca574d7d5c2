"""Per-uid dataset layout of stages 1, 2b and 3.

A copy of the parts of ``drawingspinup_tpu/core/contract.py`` that the
port reads, so both packages read and write the same files
(``<root>/<uid>/char/<drawing>.png``, ``<root>/<uid>/mv/<kind>/<view>.png``,
``<root>/<uid>/mesh/…``, ``<root>/<uid>/mesh/fbx_files/<action>.fbx``,
``<root>/<uid>/mesh/blender_render/<action>/<pass>/NNNN.png``,
``<root>/<uid>/gif/<action>.gif``). ``tests/test_torch_stage3.py``,
``tests/test_torch_recon.py`` and ``tests/test_torch_stage1.py`` pin each
path to the original.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

# the six generated views of stage 2a (and read by 2b), in order
VIEWS = ("front", "front_right", "right", "back", "left", "front_left")


@dataclass(frozen=True)
class UidPaths:
    """File locations for one character uid."""

    root: str
    uid: str

    @property
    def char_dir(self) -> str:
        return os.path.join(self.root, self.uid, "char")

    @property
    def texture(self) -> str:
        return os.path.join(self.char_dir, "texture.png")

    @property
    def mask(self) -> str:
        return os.path.join(self.char_dir, "mask.png")

    @property
    def texture_with_bg(self) -> str:
        return os.path.join(self.char_dir, "texture_with_bg.png")

    @property
    def inpainted(self) -> str:
        return os.path.join(self.char_dir, "ffc_resnet_inpainted.png")

    def mv(self, kind: str, view: str) -> str:
        assert kind in ("color", "normal", "mask"), kind
        return os.path.join(self.root, self.uid, "mv", kind, f"{view}.png")

    @property
    def mesh_dir(self) -> str:
        return os.path.join(self.root, self.uid, "mesh")

    @property
    def fbx_dir(self) -> str:
        return os.path.join(self.mesh_dir, "fbx_files")

    @property
    def render_dir(self) -> str:
        return os.path.join(self.mesh_dir, "blender_render")

    def action_dir(self, action: str) -> str:
        return os.path.join(self.render_dir, action)

    @property
    def gif_dir(self) -> str:
        return os.path.join(self.root, self.uid, "gif")

    def gif(self, action: str) -> str:
        return os.path.join(self.gif_dir, f"{action}.gif")


def load_uid_list(json_path: str) -> List[str]:
    with open(json_path) as f:
        return list(json.load(f))


def list_actions(paths: UidPaths) -> List[str]:
    """Action subdirectories present under blender_render/."""
    d = paths.render_dir
    if not os.path.isdir(d):
        return []
    return sorted(x for x in os.listdir(d) if os.path.isdir(os.path.join(d, x)))
