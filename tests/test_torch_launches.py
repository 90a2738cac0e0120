"""The port's kernel registry and its one launch path (kernels/launches.py),
on the CPU.

The kernels run only on the card, where tests/test_torch_gpu.py holds each
against its plain twin.  Here the registry is held against the CUDA
sources and the benchmark's device-trace metrics, which find the kernels
by name, and ``launches.launch`` against a stand-in library.
"""

import importlib.util
import re
import types
from pathlib import Path

import pytest
import torch

from wc_path_tracer_tpu_torch.kernels import (brute, build, cluster,
                                              launches, post, shade,
                                              traversal)

METRICS = Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
# the __global__ kernels each library defines (B1's and B2's in the sweep
# skeleton they both include; P1's three stages), and the device-trace
# metric that reads their time (none reads P1's: post_ms.serve times
# Renderer.output() between CUDA events)
GLOBALS = {"B1": ("sweep_kernel",), "B2": ("sweep_kernel",),
           "B3": ("bvh_walk_kernel",), "T1": ("shade_segment",),
           "H1": ("brute_hit",),
           "P1": ("post_down", "post_up", "post_composite"),
           "C1": ("cluster_cull",)}
READ_BY = {"B1": "hit_kernel_roofline", "B2": "hit_kernel_roofline",
           "B3": "hit_kernel_roofline", "T1": "shade_ms",
           "H1": "brute_hit_ms", "P1": None, "C1": "cull_ms"}


def _metric_matches(name):
    """The kernel-name substrings the metric ``<name>.serve`` matches."""
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", METRICS / f"{name}.serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "KERNELS", None) or (mod.KERNEL,)


@pytest.mark.parametrize("tag", sorted(launches.KERNELS))
def test_kernel_is_registered_and_named_for_its_metric(tag):
    """Each kernel is counted under its tag and named by its library, its
    wrapper is ``<library>_kernel``, and its source (with the headers it
    includes) defines its ``__global__`` kernels (one, or P1's three
    stages), whose names only the device-trace metric meant for them
    matches: a T1, H1, P1 or C1 kernel holds none of the closest-hit
    roofline's matches."""
    k = launches.KERNELS[tag]
    assert k.tag == tag and k.entry == f"wc_{k.library}"
    assert list(launches.read_counts()) == list(launches.KERNELS)
    assert launches.named(launches.zeros(**{tag: 3}))[k.library] == 3
    assert any(hasattr(m, f"{k.library}_kernel")
               for m in (brute, cluster, post, shade, traversal))
    src = build.source(k.library).read_text()
    src += "".join((build.CSRC / h).read_text()
                   for h in re.findall(r'#include "([^"]+)"', src))
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([\w, ]+\)"
                         r"\s+)?(\w+)\(", src)
    assert kernels == list(GLOBALS[tag])
    for metric in set(READ_BY.values()) - {None}:
        for kernel in kernels:
            assert any(m in kernel for m in _metric_matches(metric)) \
                == (metric == READ_BY[tag]), (metric, kernel)


def test_zero_map_names_every_kernel():
    """``zeros`` gives every kernel 0 but the tags given, refuses a tag no
    kernel has, and ``named`` keys a map by the libraries, in order."""
    zero = launches.zeros()
    assert zero == dict.fromkeys(launches.KERNELS, 0)
    assert launches.zeros(H1=5) == dict(zero, H1=5)
    with pytest.raises(ValueError, match="no kernel tagged"):
        launches.zeros(B9=1)
    assert list(launches.named(zero)) == [k.library for k in
                                          launches.KERNELS.values()]


_CPU = torch.device("cpu")
# (contiguous inputs only, the input, the device asked, the refusal)
REFUSED = {
    "dtype": (True, torch.zeros(4, 3, dtype=torch.float64), _CPU,
              "bvh_walk_kernel: x must be a contiguous torch.float32 tensor "
              "of shape (4, 3) on cpu, got torch.float64 (4, 3) on cpu "
              "contiguous=True"),
    "shape": (False, torch.zeros(4, 2), _CPU,
              "bvh_walk_kernel: x must be a torch.float32 tensor of shape "
              "(4, 3) on cpu, got torch.float32 (4, 2) on cpu"),
    "device": (False, torch.zeros(4, 3), torch.device("meta"),
               "bvh_walk_kernel: x must be a torch.float32 tensor of shape "
               "(4, 3) on meta, got torch.float32 (4, 3) on cpu"),
    "layout": (True, torch.zeros(3, 4).T, _CPU,
               "bvh_walk_kernel: x must be a contiguous torch.float32 tensor "
               "of shape (4, 3) on cpu, got torch.float32 (4, 3) on cpu "
               "contiguous=False"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_launch_refuses_inputs_off_its_table(case, monkeypatch):
    """An input of another dtype, shape or device, or (for a wrapper that
    takes only contiguous inputs) another layout, is refused before the
    library is loaded, naming the wrapper and the input; nothing is
    counted."""
    contiguous, t, device, message = REFUSED[case]
    monkeypatch.setattr(launches, "library", None)
    before = launches.read_counts()
    with pytest.raises(ValueError, match=re.escape(message)):
        launches.launch("B3", device, [("x", t, torch.float32, (4, 3))], [],
                        contiguous=contiguous)
    assert launches.read_counts() == before


def test_launch_passes_pointers_on_the_stream_and_counts(monkeypatch):
    """Tensors go to the entry as data pointers, None and ints as they are,
    the device's current stream last; a launch that returns 0 is counted,
    one that returns an error code raises with the library's string and
    is not."""
    calls, rc = [], [0]
    lib = types.SimpleNamespace(
        wc_brute_hit=lambda *a: calls.append(a) or rc[0],
        wc_cuda_error_string=lambda code: f"error {code}".encode())
    monkeypatch.setattr(launches, "library", lambda tag: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    x = torch.zeros(4, 3)
    before = launches.read_counts()
    launches.launch("H1", _CPU, [("x", x[::2], torch.float32, (2, 3)),
                                 ("y", None, torch.int32, (1,))],
                    [x, None, 5], contiguous=False)
    assert calls == [(x.data_ptr(), None, 5, 77)]
    assert launches.read_counts() == dict(before, H1=before["H1"] + 1)
    rc[0] = 700
    with pytest.raises(RuntimeError, match="brute_hit kernel launch failed: "
                                           "error 700"):
        launches.launch("H1", _CPU, [], [x])
    assert launches.read_counts() == dict(before, H1=before["H1"] + 1)
