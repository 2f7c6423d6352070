"""Build a pseudo-validation set by dropping one random modality per case
(port of the JAX package's ``cli/drop_modality.py``; host file copies).

    python -m fast_cwdm_tpu_torch.cli.drop_modality --input_dir IN --output_dir OUT [--seed 123456]

Stream-exact with the JAX package and the reference: numpy seed 123456,
one vectorized ``randint(0, 4, size=len(entries))`` over ALL sorted
directory entries (stray files consume an index but are skipped), indexed
into the ALPHABETICAL modality list ``('t1c','t1n','t2f','t2w')``. Any
deviation in list order or draw count assigns a different dropped modality
to nearly every case and makes downstream SSIM/Dice numbers incomparable.
Each output case gets a ``missing_{m}.txt`` marker.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

# the reference's alphabetical order, NOT the canonical MODALITIES tuple
# (t1n, t1c, t2w, t2f); see the module docstring
_DROP_ORDER = ("t1c", "t1n", "t2f", "t2w")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--seed", type=int, default=123456)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    entries = sorted(os.listdir(args.input_dir))
    drop_index = rng.randint(0, 4, size=len(entries)) if entries else []
    cases = [
        (i, d)
        for i, d in enumerate(entries)
        if os.path.isdir(os.path.join(args.input_dir, d))
    ]
    print(f"[drop] {len(cases)} cases → {args.output_dir}")
    for count, case in cases:
        src = os.path.join(args.input_dir, case)
        dst = os.path.join(args.output_dir, case)
        os.makedirs(dst, exist_ok=True)
        drop = _DROP_ORDER[drop_index[count]]
        for f in sorted(os.listdir(src)):
            if f"-{drop}." in f:
                continue
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
        marker = os.path.join(dst, f"missing_{drop}.txt")
        with open(marker, "w") as fh:
            fh.write(f"{case}: dropped {drop}\n")
        print(f"[drop] {case}: -{drop}")


if __name__ == "__main__":
    main()
