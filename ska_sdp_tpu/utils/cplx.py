"""A jit boundary that carries complex data as real (re, im) planes.

Complex arrays cross the host↔device boundary as pairs of real arrays and
are rebuilt with ``lax.complex`` inside the jitted program; complex
outputs come back the same way.  The pipelines' signatures are written
against this wrapper.  This module provides:

* :class:`CSplit` — a registered pytree holding (re, im) real planes of a
  complex array; it crosses the boundary as two real arrays.
* :func:`complex_safe_jit` — drop-in ``jax.jit`` replacement: complex leaves
  of inputs are split on the host, re-joined with ``lax.complex`` on-device,
  and complex outputs come back as ``CSplit`` which is re-joined to numpy on
  the host.

Replacing it with plain ``jax.jit`` is listed as design debt in
ROADMAP.md.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class CSplit:
    """A complex array carried across the device boundary as two reals."""

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __repr__(self):
        return f"CSplit(re={self.re!r}, im={self.im!r})"


def _is_complex_leaf(x) -> bool:
    dt = getattr(x, "dtype", None)
    return dt is not None and jnp.issubdtype(dt, jnp.complexfloating)


def split_complex(tree):
    """Replace complex array leaves with CSplit(re, im) real pairs.

    Host-side: complex leaves are expected as numpy arrays (a complex
    device array is fetched to the host first).
    """
    return jax.tree_util.tree_map(
        lambda x: CSplit(
            np.ascontiguousarray(np.asarray(x).real),
            np.ascontiguousarray(np.asarray(x).imag),
        )
        if _is_complex_leaf(x)
        else x,
        tree,
    )


def _join_device(tree):
    """CSplit → complex on-device (inside jit)."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.complex(
            jnp.asarray(x.re, jnp.result_type(x.re)),
            jnp.asarray(x.im, jnp.result_type(x.im)),
        )
        if isinstance(x, CSplit)
        else x,
        tree,
        is_leaf=lambda x: isinstance(x, CSplit),
    )


def _split_device(tree):
    """complex → CSplit on-device (inside jit), so outputs transfer as reals."""
    return jax.tree_util.tree_map(
        lambda x: CSplit(jnp.real(x), jnp.imag(x)) if _is_complex_leaf(x) else x,
        tree,
    )


def join_complex_host(tree):
    """CSplit → complex numpy on the host (after transfer)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.re) + 1j * np.asarray(x.im)
        if isinstance(x, CSplit)
        else x,
        tree,
        is_leaf=lambda x: isinstance(x, CSplit),
    )


def complex_safe_jit(fn, **jit_kwargs):
    """jax.jit whose traced boundary carries complex data as real pairs.

    The returned callable accepts/returns complex arrays exactly like ``fn``;
    outputs are host values (numpy for complex leaves, device arrays
    otherwise — call sites that need device residency should keep data real).
    """

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        args = _join_device(args)
        kwargs = _join_device(kwargs)
        return _split_device(fn(*args, **kwargs))

    jitted = jax.jit(inner, **jit_kwargs)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        out = jitted(*split_complex(args), **split_complex(kwargs))
        return join_complex_host(out)

    call._jitted = jitted  # for AOT/inspection
    return call
