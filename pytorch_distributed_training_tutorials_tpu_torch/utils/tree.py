"""Tree path helpers (port of the JAX package's ``utils/tree.py``).

The JAX module's ``device_materialize`` (rewriting host-numpy leaves as
device outputs, so a jitted call stops re-uploading them) is not ported:
a tensor placed on the card is resident already.
"""

from __future__ import annotations


def keystr(key_path) -> str:
    """``'blocks/0/attn/q_proj'``-style path string: the JAX package's
    slash path, from a key path (a tuple of keys, as the port's tree walks
    and checkpoints give them) or from a state dict's dotted name. The
    flax module names themselves (``block_0``, ``kernel``) are
    :mod:`..models.convert`'s."""
    parts = key_path.split(".") if isinstance(key_path, str) else key_path
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in parts)
