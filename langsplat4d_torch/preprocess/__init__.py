"""Offline preprocessing (port of langsplat4d/preprocess/)."""
