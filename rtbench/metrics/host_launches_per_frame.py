"""Kernel and graph launches the host made per preview frame, over the
traced frames (the window's first: replays while the camera holds, a move
and its eager iteration each while it is dragged)."""


def read(t):
    if not t.frames:
        return None
    return t.launches(("frames",)) / t.frames
