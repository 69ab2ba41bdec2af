"""Generate the no-head robot's MJCF from the full duck model.

    python -m open_duck_playground_torch.tools.gen_no_head_xml --out PATH \\
        [--src open_duck_mini_v2.xml]

Counterpart of the JAX package's `tools/gen_no_head_xml.py`, with
`xml.etree` only: the neck and head chain (the bodies under
`neck_pitch_assembly`: the joints neck_pitch, head_pitch, head_yaw and
head_roll) and their 4 position actuators are removed. Assets that only
the head used stay in the asset table (unused assets are legal MJCF). The
output is byte for byte the committed `open_duck_mini_v2_no_head.xml`,
header comment included. The source is read from the robot's XML
directory (`duck_base.XML_DIR`) unless `--src` names another file; the
output goes to `--out`, which the caller gives: the tool writes nowhere
else. The port itself reads the no-head robot from its snapshot
(`models/data/`); a changed XML needs `python -m
open_duck_playground_torch.models.snapshot` after this.
"""

from __future__ import annotations

import argparse
import pathlib
import xml.etree.ElementTree as ET

HEAD_ROOT_BODY = "neck_pitch_assembly"
HEAD_ACTUATORS = {"neck_pitch", "head_pitch", "head_yaw", "head_roll"}


def strip_head(src: pathlib.Path, dst: pathlib.Path) -> dict:
    """Write the no-head model of `src` to `dst`; returns what was removed."""
    tree = ET.parse(src)
    root = tree.getroot()
    root.set("model", "open_duck_mini_v2_no_head")
    removed_bodies = removed_acts = 0
    for parent in root.iter():
        for child in list(parent):
            if child.tag == "body" and child.get("name") == HEAD_ROOT_BODY:
                parent.remove(child)
                removed_bodies += 1
            elif child.tag == "position" and child.get("name") in HEAD_ACTUATORS:
                parent.remove(child)
                removed_acts += 1
    if removed_bodies != 1:
        raise ValueError(f"head chain {HEAD_ROOT_BODY!r} not found once in {src} ({removed_bodies})")
    if removed_acts != len(HEAD_ACTUATORS):
        raise ValueError(f"{removed_acts} of the {len(HEAD_ACTUATORS)} head actuators found in {src}")
    ET.indent(tree, space="  ")
    dst.write_bytes(b'<?xml version="1.0"?>\n<!-- Generated by tools/gen_no_head_xml.py from '
                    + src.name.encode() + b" - do not edit by hand -->\n" + ET.tostring(root))
    return {"src": str(src), "out": str(dst), "removed_bodies": removed_bodies, "removed_actuators": removed_acts}


def main(argv=None, device="cuda") -> dict:
    """Write the file; returns a record of what was removed. `device` is
    the tools' common argument: the tool runs on the host alone."""
    from open_duck_playground_torch.envs import duck_base

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(duck_base.XML_DIR / "open_duck_mini_v2.xml"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    record = {"tool": "gen_no_head_xml", **strip_head(pathlib.Path(args.src), pathlib.Path(args.out))}
    print(f"wrote {args.out}", flush=True)
    return record


if __name__ == "__main__":
    main()
