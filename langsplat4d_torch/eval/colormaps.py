"""Colormaps for relevancy and heatmap pictures (port of
langsplat4d/eval/colormaps.py; reference eval/colormaps.py + eval/colors.py,
nerfstudio-derived).

A scalar map goes through the turbo colormap, a table of 256 colours kept
here (matplotlib's, rounded to bytes: within 0.5/255 of it); a map of more
than three channels goes to three by PCA (`pca3`), a projection on the top
three principal components with scikit-learn's sign rule, computed in
float64 with torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# turbo, 256 RGB byte triples (matplotlib's `_turbo_data` rounded to bytes)
_TURBO_HEX = (
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c3286"
    "3d358b3e38913f3b973f3e9c4040a24143a74146ac4249b1424bb5434eba4451bf4454c3"
    "4456c74559cb455ccf455ed34661d64664da4666dd4669e0466be3476ee64771e94773eb"
    "4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff5"
    "2fb2f42eb4f22cb7f02ab9ee28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda"
    "1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc518ddc218dec018e0bd19e2bb"
    "19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb73"
    "5dfc6f61fc6c65fd6969fd666dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e"
    "8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3da4fc3ca7fc3aa9fb39acfb38"
    "affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938"
    "e7d739e9d539ebd339ecd13aeecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13a"
    "f8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35fdac34fea933fea732fea431"
    "fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13"
    "f05b12ef5811ed5510ec530feb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109"
    "df3f08dd3d08dc3b07da3907d83706d63506d43305d23105d02f05ce2d04cc2b04ca2a04"
    "c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b0902880802"
    "8507028106027e05027a0403"
)
TURBO = np.frombuffer(bytes.fromhex(_TURBO_HEX), np.uint8).reshape(
    256, 3).astype(np.float64) / 255.0


@dataclass
class ColormapOptions:
    colormap: str = "turbo"
    normalize: bool = False
    colormap_min: float = 0.0
    colormap_max: float = 1.0
    invert: bool = False


def pca3(flat: torch.Tensor) -> torch.Tensor:
    """[N, C] -> [N, 3] float64: the rows projected on the top three
    principal components, each component signed so that its largest
    entry in absolute value is positive (scikit-learn's PCA: `svd_flip`
    with `u_based_decision=False`). Through the covariance's eigenvectors,
    as scikit-learn's solver for tall inputs."""
    x = flat.to(torch.float64)
    x = x - x.mean(dim=0)
    cov = x.T @ x / max(x.shape[0] - 1, 1)
    _, vecs = torch.linalg.eigh(cov)                  # ascending
    comps = vecs.flip(1)[:, :3].T                      # [3, C]
    pick = comps.abs().argmax(dim=1)
    comps = comps * torch.sign(comps[torch.arange(3), pick])[:, None]
    return x @ comps.T


def apply_colormap(image: np.ndarray,
                   colormap_options: ColormapOptions = ColormapOptions(),
                   eps: float = 1e-9) -> np.ndarray:
    """[H,W,1] scalar map -> [H,W,3] colours; [H,W,3] passes through
    (clipped); wider maps are PCA-compressed to [0, 1]."""
    if image.shape[-1] == 3:
        return np.clip(image, 0, 1)
    if image.shape[-1] == 1:
        out = image[..., 0].astype(np.float64)
        if colormap_options.normalize:
            out = out - out.min()
            out = out / (out.max() + eps)
        out = (out * (colormap_options.colormap_max
                      - colormap_options.colormap_min)
               + colormap_options.colormap_min)
        out = np.clip(out, 0, 1)
        if colormap_options.invert:
            out = 1 - out
        return _scalar_colormap(out, colormap_options.colormap)
    h, w, c = image.shape
    out = pca3(torch.from_numpy(np.ascontiguousarray(image)).reshape(-1, c))
    out = out.numpy().reshape(h, w, 3)
    return (out - out.min()) / (out.max() - out.min() + eps)


def _scalar_colormap(x: np.ndarray, name: str) -> np.ndarray:
    """x in [0, 1] -> the table's entry floor(256 x) (255 at 1), as a
    matplotlib colormap of 256 entries looks a value up."""
    if name != "turbo":
        raise NotImplementedError(f"colormap {name!r}: the port has turbo")
    idx = np.clip((x * 256).astype(np.int64), 0, 255)
    return TURBO[idx]
