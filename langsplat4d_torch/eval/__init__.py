"""Open-vocabulary evaluation: relevancy, colormaps, mIoU / vIoU (port of
langsplat4d/eval and the root eval.py)."""
