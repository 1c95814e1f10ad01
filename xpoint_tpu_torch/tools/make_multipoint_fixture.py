"""Write the MULTIPOINT-layout micro-fixture (port of
``tools/make_multipoint_fixture.py``).

    python -m xpoint_tpu_torch.tools.make_multipoint_fixture
        [--out outputs/multipoint_micro.npz]

The real MULTIPOINT corpus cannot be fetched here, so this few-hundred-KB
stand-in pins the layout the reference loader reads:

    <member name>/optical      float32 (H, W) in [0, 1]
    <member name>/thermal      float32 (H, W) in [0, 1]
    <member name>/thermal_raw  uint16  (H, W)   (optional; raw_thermal: true)

with the reference's fallback branches: one member carries thermal_raw next
to thermal, one has no thermal at all (the loader then uses a copy of the
optical image). Member names are timestamp-style strings, images 96 x 128.
The arrays are the JAX tool's, bit for bit (the same generator and order);
the file is HDF5 for a ``.hdf5`` / ``.h5`` suffix and an ``.npz`` of the
same groups otherwise (``data/group_file.py``). The default path is not the
JAX tool's (``tests/data/multipoint_micro.hdf5``).
"""
import argparse
import os

import numpy as np

from ..data.group_file import write_groups
from .make_mini_corpus import optical_image, pseudo_thermal

SHAPE = (96, 128)
# timestamp-style member names like the real corpus, deliberately unsorted
MEMBERS = ["1566481721_4806340", "1566481725_1093750", "1566481719_0312500"]


def fixture_groups():
    """{member: {name: array}} of the fixture (seed 7)."""
    rng = np.random.default_rng(7)
    groups = {}
    for i, name in enumerate(MEMBERS):
        opt = optical_image(rng, SHAPE)
        th = pseudo_thermal(opt, rng)
        g = groups[name] = {"optical": opt.astype(np.float32)}
        if i == 2:
            # optical-only member: the loader must use thermal = optical
            continue
        g["thermal"] = th.astype(np.float32)
        if i == 0:
            g["thermal_raw"] = (th * 65535.0).astype(np.uint16)
    return groups


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="outputs/multipoint_micro.npz")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_groups(args.out, fixture_groups())
    size = os.path.getsize(args.out)
    print(f"fixture written to {args.out} ({size/1024:.0f} KB, "
          f"{len(MEMBERS)} members @{SHAPE})")


if __name__ == "__main__":
    main()
