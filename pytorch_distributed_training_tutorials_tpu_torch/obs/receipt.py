"""One schema'd receipt for every performance claim (port of the JAX
package's ``obs/receipt.py``).

    receipt = make_receipt("bench_headline", payload, mesh=mesh, drift=...)
    write_receipt(path, receipt)

The envelope is flat-merged with the payload (payload keys stay top level)
and adds ``schema``, ``kind``, ``env`` and an optional ``drift``, under the
JAX schema's names. The environment stamp is restated for PyTorch: the git
sha, torch and CUDA versions, the backend, the device count and name, the
world's data axis, and ``nvidia-smi --query-gpu=name,power.limit`` on a
card (a card may run below its maximum power limit, and then slower).
:func:`validate_receipt` checks a schema'd receipt and, in legacy mode, a
pre-schema payload.
"""

from __future__ import annotations

import json
import os
import subprocess

SCHEMA = "graft-receipt/v1"

# known receipt kinds: one per number-producing entry point
KINDS = frozenset({
    "bench_headline", "lm_headline", "llm_mfu_sweep", "serving", "profile_step",
    "profile_decode", "launch_probe", "obs_selftest", "serve_selftest",
})

_ENVELOPE_KEYS = ("schema", "kind", "env", "drift")
# what every stamp carries, beside its framework's version: the port's
# torch_version, or jax_version on a receipt of the JAX package (the
# repo's receipt history starts there, and bench/regress.py reads it)
_ENV_KEYS = ("backend", "device_count")
_VERSION_KEYS = ("torch_version", "jax_version")


def _git_sha() -> str | None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
                             text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _nvidia_smi() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def environment_stamp(mesh=None, device=None) -> dict:
    """git sha, torch and CUDA versions, backend (``cuda`` or ``cpu``),
    device count and name, ``nvidia-smi``'s name and power limit (on a
    card), and ``mesh``'s data axis."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    on_card = dev.type == "cuda"
    stamp = {
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": dev.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "nvidia_smi": _nvidia_smi() if on_card else None,
    }
    if mesh is not None:
        stamp["mesh"] = {DATA_AXIS: axis_size(mesh, DATA_AXIS)}
    return stamp


def make_receipt(kind: str, payload: dict, *, mesh=None, drift: dict | None = None,
                 device=None) -> dict:
    """Envelope ``payload`` (flat merge) with the schema and the
    environment stamp."""
    if kind not in KINDS:
        raise ValueError(f"unknown receipt kind {kind!r}; known: {', '.join(sorted(KINDS))}")
    clash = set(payload) & set(_ENVELOPE_KEYS)
    if clash:
        raise ValueError(f"payload keys collide with envelope: {clash}")
    receipt = dict(payload)
    receipt["schema"] = SCHEMA
    receipt["kind"] = kind
    receipt["env"] = environment_stamp(mesh=mesh, device=device)
    if drift is not None:
        receipt["drift"] = drift
    return receipt


def write_receipt(path: str | None, receipt: dict) -> dict:
    """Validate and write a receipt (no write when ``path`` is None)."""
    problems = validate_receipt(receipt)
    if problems:
        raise ValueError("invalid receipt: " + "; ".join(problems))
    if path:
        with open(path, "w") as f:
            json.dump(receipt, f, indent=2)
            f.write("\n")
    return receipt


def validate_receipt(obj, kind: str | None = None) -> list[str]:
    """Problems with a receipt (an empty list: valid). A schema'd receipt
    (``schema`` present) has its envelope checked in full (a JAX-package
    receipt's stamp carries ``jax_version`` where the port's carries
    ``torch_version``); a legacy one must be a non-empty dict carrying at
    least one number."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return ["receipt is not a dict"]
    if "schema" not in obj:
        return _validate_legacy(obj, kind)
    if obj["schema"] != SCHEMA:
        problems.append(f"unknown schema {obj['schema']!r}")
    k = obj.get("kind")
    if k not in KINDS:
        problems.append(f"unknown kind {k!r}")
    if kind is not None and k != kind:
        problems.append(f"kind {k!r} != expected {kind!r}")
    env = obj.get("env")
    if not isinstance(env, dict):
        problems.append("missing env stamp")
    else:
        for key in _ENV_KEYS:
            if key not in env:
                problems.append(f"env stamp missing {key!r}")
        if not any(key in env for key in _VERSION_KEYS):
            problems.append("env stamp missing 'torch_version'")
    drift = obj.get("drift")
    if drift is not None and not isinstance(drift, dict):
        problems.append("drift must be a dict (DriftBracket.to_dict())")
    if not [key for key in obj if key not in _ENVELOPE_KEYS]:
        problems.append("empty payload (envelope only)")
    return problems


def _validate_legacy(obj: dict, kind: str | None) -> list[str]:
    if not obj:
        return ["legacy receipt is empty"]

    def numbers(o):
        if isinstance(o, bool):
            return
        if isinstance(o, (int, float)):
            yield o
        elif isinstance(o, dict):
            for v in o.values():
                yield from numbers(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                yield from numbers(v)

    if not any(True for _ in numbers(obj)):
        return ["legacy receipt carries no numeric measurement"]
    if kind == "bench_headline":
        line = obj.get("parsed") if isinstance(obj.get("parsed"), dict) else obj
        missing = [k for k in ("metric", "value", "unit") if k not in line]
        if missing:
            return [f"legacy bench payload missing {missing}"]
    return []


def load_receipt(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
