#!/usr/bin/env python3
"""Writes ``manifold_gp_torch/data/digits.npz``: scikit-learn's bundled
1,797 8x8 digits (``sklearn.datasets.load_digits``, read from the installed
package; nothing is fetched), the offline stand-in for MNIST that
``manifold_gp_torch.utils.datasets._surrogate_digits`` upsamples.

  images  uint8 [1797, 8, 8], values 0-16 (``load_digits().images``, which
          holds small integers as float64: the cast is exact)
  target  int64 [1797]

The port never imports scikit-learn; this helper is how the file was made.

  python tests/_digits_data.py [--out manifold_gp_torch/data/digits.npz]
"""

import argparse
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "manifold_gp_torch" / "data" / "digits.npz"


def digits_arrays():
    from sklearn.datasets import load_digits

    d = load_digits()
    images = np.asarray(d.images)
    if not (np.array_equal(images, np.round(images)) and images.min() >= 0
            and images.max() <= 16):
        raise ValueError("load_digits().images are not integers in [0, 16]")
    return images.astype(np.uint8), np.asarray(d.target).astype(np.int64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    args = ap.parse_args()
    images, target = digits_arrays()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, images=images, target=target)
    print(f"wrote {args.out}: images {images.shape} {images.dtype}, target {target.shape}")


if __name__ == "__main__":
    main()
