"""The PyTorch port imports without JAX, and its kernels build lazily."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ucoslam_tpu_torch, ucoslam_tpu_torch.api, ucoslam_tpu_torch.io.synthetic\n"
        "import ucoslam_tpu_torch.ops.cuda.match_kernel, ucoslam_tpu_torch.ops.cuda.lm_kernel\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "from ucoslam_tpu_torch.ops import cuda\n"
        "assert cuda.load_library.cache_info().currsize == 0, 'a kernel was built at import'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "ucoslam_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name
