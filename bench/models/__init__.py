"""One module per trunk type: ``bench/models/<model_type>.py``.

A configuration file names its ``model_type``; :func:`of` loads the
module of that name from :data:`DIR` by path, as ``harness.reader``
loads a metric's file, so a new trunk enters the benchmark as a new file.
Each module holds everything of its type and nothing shared:

* ``sizes(cfg)``: the sizes its layout and FLOP count read;
* ``layout(cfg)``: the leaves ``(key path, shape, kind)`` of the port's
  checkpoints, in the order :func:`bench.weights.draw` cuts its buffer;
* ``MATRICES``: the leaves that are weights of products (stacked
  ``(L, in, out)``), which the fp8 control rounds;
* ``trunk(cfg, W, tok, valid, precision)``: the reference's last hidden
  states in float32, widening a layer's weights when it reaches them;
* ``flops(cfg, n_tokens)``: forward FLOPs of one sequence;
* ``port_fields(cfg)``: the sizes and options the port's
  ``TransformerConfig`` has to hold (:func:`bench.port.transformer_config`);
* ``SMALL``: the sizes of the benchmark's CPU tests, in the file's keys.
"""

from __future__ import annotations

import importlib.util
import os

DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(DIR))
_LOADED: dict = {}


def path(model_type: str) -> str:
    return os.path.join(DIR, f"{model_type}.py")


def of(cfg: dict):
    """The module of ``cfg["model_type"]``; a run stops with the name of
    the missing file where there is none."""
    file = path(cfg["model_type"])
    if file not in _LOADED:
        if not os.path.isfile(file):
            shown = os.path.relpath(file, _ROOT) \
                if file.startswith(_ROOT + os.sep) else file
            raise SystemExit(f"no trunk for model_type "
                             f"{cfg['model_type']!r}: {shown} is missing")
        spec = importlib.util.spec_from_file_location(
            "bench_model_" + "".join(c if c.isalnum() else "_"
                                     for c in cfg["model_type"]), file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[file] = mod
    return _LOADED[file]
