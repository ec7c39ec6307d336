"""The port stands alone: importing every `ddg_tpu_torch` module, and
`chip_smoke`, loads neither JAX nor any module of the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    '.'.join(p.relative_to(ROOT).with_suffix('').parts).removesuffix(
        '.__init__')
    for p in (ROOT / 'ddg_tpu_torch').rglob('*.py')) + ['chip_smoke']

PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ddg_tpu'))
print(json.dumps(bad))
"""


def test_module_list_covers_the_package():
    assert 'ddg_tpu_torch.samplers' in MODULES
    assert 'ddg_tpu_torch.ops.fused_sampling' in MODULES
    for name in ('ops.losses', 'runtime.optim', 'runtime.averaging',
                 'runtime.train_state', 'ops.groupnorm', 'models.unet',
                 'ops.mamba', 'models.dimamba', 'entry', 'diffusion',
                 'ops._build', 'classifier', 'models.dit_decode',
                 'models.dimamba_decode'):
        assert f'ddg_tpu_torch.{name}' in MODULES
    assert len(MODULES) >= 19


def test_imports_pull_in_no_jax():
    """One fresh interpreter imports every module: what it loads is a
    superset of what any one of them loads alone."""
    out = subprocess.run([sys.executable, '-c', PROBE, *MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]', out.stdout


def test_no_library_kernels_in_the_port():
    """The port's kernels are its own: no library attention, LayerNorm,
    GroupNorm or compiler stands in for one. `group_norm` is banned as a
    word (F.group_norm, torch.group_norm), which leaves the port's own
    `fused_group_norm_act`."""
    banned = ('scaled_dot_product_attention', 'F.layer_norm',
              'torch.compile', 'nn.GroupNorm', 'native_group_norm',
              'import jax', 'from jax', 'import flax',
              'from ddg_tpu ', 'from ddg_tpu.', 'import ddg_tpu\n',
              'import ddg_tpu.')
    for path in (ROOT / 'ddg_tpu_torch').rglob('*.py'):
        text = path.read_text()
        for word in banned:
            assert word not in text, (path, word)
        assert not re.search(r'\bgroup_norm\b', text), path
