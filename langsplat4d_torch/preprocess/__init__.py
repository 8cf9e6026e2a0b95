"""Offline preprocessing (port of langsplat4d/preprocess/)."""
from __future__ import annotations

import importlib
import os


def local_model(model_path, model: str, package: str):
    """Import `package` for the model `model` kept at `model_path`, a local
    directory, and return the module. The port downloads nothing: without a
    local copy, or without the package, this raises and names the model."""
    if not model_path or not os.path.isdir(model_path):
        raise RuntimeError(
            f"{model} is not in the repository and nothing is downloaded: "
            f"pass the directory of a local copy (--model_path); got "
            f"{model_path!r}")
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise RuntimeError(f"{model} at {model_path} needs the {package!r} "
                           f"package, which is not installed") from e
