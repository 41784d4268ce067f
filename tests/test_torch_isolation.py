"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``,
``scripts/torch_{kernel,legacy}_ab.py``, ``scripts/torch_{dense,kimi}_phase.py``
and the card's test file ``tests/test_torch_cuda.py`` import neither JAX
nor the JAX package, and the port loads and runs with both blocked: it
serves, runs an RCC experiment and takes two training steps."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    files += [os.path.join(ROOT, "scripts", f"torch_{name}.py") for name in ("kernel_ab", "legacy_ab", "dense_phase",
                                                                             "kimi_phase")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_loads_and_runs_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
        "from repro_torch import api, convert\n"
        "import repro_torch.core.protocols, repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.models.decode\n"
        "from repro_torch.configs import reduced_config\n"
        "from repro_torch.launch.serve import serve\n"
        "res = serve(reduced_config('stablelm-1.6b'), batch=2, prompt_len=8, gen_len=3, device='cpu')\n"
        "assert tuple(res.tokens.shape) == (2, 3)\n"
        "r = api.run(api.ExperimentSpec(protocol='nowait', workload='smallbank', configs=[{'hybrid': 63}],\n"
        "    n_nodes=2, coroutines=4, records_per_node=32, ticks=8, warmup=2, device='cpu'))\n"
        "assert r.row['commits'] > 0\n"
        "import repro_torch.optim.compression, repro_torch.checkpoint, repro_torch.ft.runner\n"
        "from repro_torch.launch import train\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    out = train.main(['--reduced', '--device', 'cpu', '--steps', '2', '--batch', '2', '--seq', '16'])\n"
        "assert out['final_step'] == 2 and len(out['losses']) == 2\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
