"""HDF5 tree inspector: `python -m adt_str_tpu_torch.utils.inspect_hdf5 <file.hdf5> [--max-depth N]`.

Port of `adt_str_tpu/utils/inspect_hdf5.py`: prints each group with the
number of datasets under it, children in name order. Host-only; it needs
h5py (without it the import raises).
"""

from __future__ import annotations

import argparse


def build_group_tree(group) -> dict:
    """-> nested {"_datasets": count under the group, "_children": {name: subtree}}."""
    import h5py

    tree: dict = {"_datasets": 0, "_children": {}}
    for name, item in group.items():
        if isinstance(item, h5py.Group):
            sub = build_group_tree(item)
            tree["_children"][name] = sub
            tree["_datasets"] += sub["_datasets"]
        else:
            tree["_datasets"] += 1
    return tree


def print_group_tree(tree: dict, name: str = "/", depth: int = 0, max_depth: int | None = None) -> None:
    print(f"{'  ' * depth}{name} ({tree['_datasets']} datasets)")
    if max_depth is not None and depth >= max_depth:
        return
    for child_name, sub in sorted(tree["_children"].items()):
        print_group_tree(sub, child_name, depth + 1, max_depth)


def main(argv: list[str] | None = None) -> None:
    import h5py

    parser = argparse.ArgumentParser(description="print an HDF5 file's group tree with dataset counts")
    parser.add_argument("path", type=str)
    parser.add_argument("--max-depth", type=int, default=None)
    args = parser.parse_args(argv)
    with h5py.File(args.path, "r") as f:
        print_group_tree(build_group_tree(f), "/", max_depth=args.max_depth)


if __name__ == "__main__":
    main()
