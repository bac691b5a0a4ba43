"""Identity of the accelerator a measurement runs on."""

import subprocess

import jax


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU. Measurements never
    fall back to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")


def card_line() -> str:
    """`name, power.limit` of the card(s) as nvidia-smi reports them (a
    card below its maximum power limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
