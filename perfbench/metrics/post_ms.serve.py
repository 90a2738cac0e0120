"""Milliseconds of Renderer.output() per frame (bloom, tonemap, gamma,
uint8, the copy to the host), between CUDA events that the serving loop
records around each output() call of the traced run, mean over its
frames."""


def read(view):
    ms = view.spans.get("post_ms") or []
    return sum(ms) / len(ms) if ms else None
