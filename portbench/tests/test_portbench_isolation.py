"""In a fresh interpreter: a whole run of every cell (the tiny CPU size)
loads no JAX, jaxlib, Flax or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); the
plain reference loads nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests import tiny


def fresh(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_run_loads_jax_or_the_jax_package():
    found = fresh(
        "import json, sys\n"
        "sys.path.insert(0, %r)\n"
        "from portbench.harness import core\n"
        "from portbench.tests import tiny\n"
        "for w in tiny.WORKLOADS:\n"
        "    assert tiny.run(w)[0]['correct'], w\n"
        "print(json.dumps([core.forbidden_modules(),\n"
        "                  'audiotools_tpu_torch' in sys.modules]))\n"
        % (tiny.ROOT,))
    assert found == [[], True]


def test_the_reference_loads_nothing_of_the_program():
    top = fresh(
        "import json, sys\n"
        "sys.path.insert(0, %r)\n"
        "import portbench.reference.flac_decode, portbench.reference.flac_enc\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (tiny.ROOT,))
    for name in ("audiotools_tpu_torch", "audiotools_tpu", "jax", "jaxlib",
                 "flax", "torch"):
        assert name not in top


def test_forbidden_names_are_compared_whole():
    from portbench.harness import core
    sys.modules["audiotools_tpu_torch_probe"] = sys
    try:
        assert "audiotools_tpu_torch_probe" not in core.forbidden_modules()
    finally:
        del sys.modules["audiotools_tpu_torch_probe"]
