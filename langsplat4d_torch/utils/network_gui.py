"""TCP viewer bridge (port of langsplat4d/utils/network_gui.py; reference
gaussian_renderer/network_gui.py:26-85): a non-blocking listener, JSON
camera messages in (a 4-byte little-endian length, then UTF-8 JSON), raw
RGB bytes out followed by the source path, polled from the training loop
(`train/loop._gui_poll`, reference train.py:166-191). Standard library
sockets and the same messages, so the reference's viewer connects as it
does to the JAX package.
"""
from __future__ import annotations

import json
import logging
import socket
from typing import Optional, Tuple

import numpy as np

from langsplat4d_torch.data.cameras import MiniCam

logger = logging.getLogger(__name__)

host = "127.0.0.1"
port = 6009
conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None


def init(wish_host: str, wish_port: int) -> None:
    """Listen on (wish_host, wish_port) without blocking."""
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def drop() -> None:
    """Close the viewer's connection; the listener stays."""
    global conn
    if conn is not None:
        conn.close()
    conn = None


def close() -> None:
    """Close the connection and the listener."""
    global listener
    drop()
    if listener is not None:
        listener.close()
    listener = None


def try_connect() -> None:
    """Accept a pending viewer, if any (one non-blocking accept)."""
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
    except (BlockingIOError, socket.timeout):
        return
    logger.info("viewer connected from %s", addr)
    conn.settimeout(None)


def _recv_exactly(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("viewer closed the connection")
        buf += part
    return buf


def read() -> dict:
    length = int.from_bytes(_recv_exactly(4), "little")
    return json.loads(_recv_exactly(length).decode("utf-8"))


def send(message_bytes: Optional[bytes], verify: str) -> None:
    """The frame's bytes (if any), then the length and text of `verify`
    (the source path)."""
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive() -> Tuple[Optional[MiniCam], bool, bool, bool, bool, float]:
    """-> (custom_cam, do_training, convert_SHs, compute_cov3D, keep_alive,
    scaling_modifier), the message schema of network_gui.py:56-85; all None
    when the message asks for no frame (resolution 0)."""
    message = read()
    width, height = message["resolution_x"], message["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None
    world_view = np.reshape(np.array(message["view_matrix"]),
                            (4, 4)).astype(np.float32)
    world_view[:, 1] = -world_view[:, 1]
    world_view[:, 2] = -world_view[:, 2]
    full_proj = np.reshape(np.array(message["view_projection_matrix"]),
                           (4, 4)).astype(np.float32)
    full_proj[:, 1] = -full_proj[:, 1]
    cam = MiniCam(width, height, message["fov_y"], message["fov_x"],
                  message["z_near"], message["z_far"], world_view, full_proj)
    return (cam, bool(message["train"]), bool(message["shs_python"]),
            bool(message["rot_scale_python"]), bool(message["keep_alive"]),
            message["scaling_modifier"])
