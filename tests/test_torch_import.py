"""nmc_tpu_torch must import where JAX is not installed, as on the machine
with the card: every submodule imports with `jax` blocked, and nothing in
the package imports JAX or the JAX package. The machine with the card has
no matplotlib either: the shims and the figures import without it."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "nmc_tpu_torch"


def test_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now raises
        sys.path.insert(0, {str(PKG.parent)!r})
        import nmc_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            nmc_tpu_torch.__path__, "nmc_tpu_torch.")
            if m.name != "nmc_tpu_torch.__main__"]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m, mod in sys.modules.items() if mod is not None
                  and (m.split(".")[0] in ("nmc_tpu", "jax", "jaxlib"))]
        assert not leaked, leaked
        import torch
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 16


NEW_MODULES = ("nmc_tpu_torch.compat", "nmc_tpu_torch.compat.faithful",
               "nmc_tpu_torch.parallel.ensemble", "nmc_tpu_torch.native",
               "nmc_tpu_torch.utils.plotting",
               "nmc_tpu_torch.parallel.distributed",
               "nmc_tpu_torch.parallel.sharded_pt",
               "nmc_tpu_torch.parallel.spin_sharded",
               "nmc_tpu_torch.parallel.dryrun")


def test_new_modules_import_without_jax_or_matplotlib():
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "matplotlib", "matplotlib.pyplot"):
            sys.modules[blocked] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
        from nmc_tpu_torch.compat import (APT_ICM, NMC, NPT, APT_preprocessor,
                                          LRUFieldCache, mcmc_sequential)
        from nmc_tpu_torch.parallel import (EnsembleConfig, EnsemblePT,
                                            EnsembleState)
        from nmc_tpu_torch.native import (CSRAdjacency, backbone_clusters,
                                          connected_components_masked)
        from nmc_tpu_torch import EnsemblePT as E, sequential_sweeps
        from nmc_tpu_torch.utils import plotting
        for fig in ("plot_nmc_results", "plot_energies", "plot_beta_sigma",
                    "plot_campaign", "plot_hardness_curve",
                    "plot_residual_trace", "plot_hardness_surface"):
            assert callable(getattr(plotting, fig))
        try:
            plotting._plt()
        except ImportError as e:
            assert e.name == "matplotlib", e
        else:
            raise AssertionError("matplotlib imported while blocked")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import nmc_tpu\b|"
                         r"from nmc_tpu\b(?!_torch))", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders
