"""Build a Neu3D scene's train and test splits and print their image counts
(port of langsplat4d/preprocess/preprocess_neu3d.py; reference
preprocess/preprocess_neu3d.py:1-14).

    python -m langsplat4d_torch.preprocess.preprocess_neu3d --datadir <scene>

In the reference and the JAX package, building the dataset extracts each
camera's frames from its camNN.mp4 as a side effect. The port decodes no
video: the frames must already lie under camNN/images/ (README.md, "Neu3D
frames"), and a camera with only its video raises, naming it. So here the
command checks that a scene's frames are in place and counts them.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser(description="Check and count a Neu3D scene's "
                                        "extracted frames")
    parser.add_argument("--datadir", type=str, required=True)
    args = parser.parse_args(argv)

    from langsplat4d_torch.data.readers import Neu3DDataset
    train = Neu3DDataset(args.datadir, "train", downsample=1.0, eval_index=0)
    test = Neu3DDataset(args.datadir, "test", downsample=1.0, eval_index=0)
    print(f"extracted frames: train {len(train.image_paths)} images, "
          f"test {len(test.image_paths)} images")
    return len(train.image_paths), len(test.image_paths)


if __name__ == "__main__":
    main(sys.argv[1:])
