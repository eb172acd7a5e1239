"""Neural diode root: a small MLP standing in for the diode-pair nonlinearity.

Capability parity with the reference's two neural-root implementations:

- Python training side ``wdf_py/lib/layers.py:42-82`` (DenseRootModel):
  input [incident wave a, log(port R)], dense/tanh stack, linear head;
- C++ inference side ``plugin/src/dsp/diode_clipper/DiodePairNeuralModel.h``
  (RTNeural ModelT): ``reflected`` returns ``b = -model.forward({a, logR})``.

Sign convention: the network is trained to predict the *negated* reflected
wave (the reference multiplies targets by -1, ``diode_pretraining.py:98-102``,
and negates at the WDF boundary, ``clipper_pot.py:121`` /
``DiodePairNeuralModel.h:68-73``).  ``NeuralDiodeRoot.reflect`` applies the
negation, so it is a drop-in replacement for ``DiodePairRoot``.

There is no need for an RTNeural-style hand-specialized engine: XLA *is*
the optimizing inference compiler.  The MLP is expressed as stacked
matmuls over the batch; weights interchange with the
reference's JSON model zoo via ``diffwdf.nn.serialization``.

Design note: activation names are *static* structure (attributes of the root /
arguments to ``mlp_apply``), never leaves of the params pytree, so the params
remain a clean array-only pytree for grad/optax/sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.circuit import Root

_ACTS = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "sigmoid": jax.nn.sigmoid,
    "softmax": jax.nn.softmax,
    "": lambda x: x,
    "linear": lambda x: x,
}

#: params pytree for an MLP: {"layers": [{"kernel": [in,out], "bias": [out]}]}
MLPParams = Dict[str, List[Dict[str, Any]]]


def mlp_init(key, sizes: Sequence[int], dtype=jnp.float32) -> MLPParams:
    """Orthogonal-kernel / zero-bias init (parity with the reference's keras
    ``kernel_initializer="orthogonal"``, ``diode_pretraining.py:121-123``)."""
    init = jax.nn.initializers.orthogonal()
    layers = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        layers.append(
            {
                "kernel": init(sub, (din, dout), dtype),
                "bias": jnp.zeros((dout,), dtype),
            }
        )
    return {"layers": layers}


def mlp_apply(params: MLPParams, activations: Sequence[str], x):
    """Apply a dense stack. x: [..., d_in] -> [..., d_out]."""
    for layer, act in zip(params["layers"], activations):
        x = x @ layer["kernel"] + layer["bias"]
        x = _ACTS[act](x)
    return x


def mlp_arch(n_layers: int, layer_size: int, d_in: int = 2, d_out: int = 1):
    """The reference's architecture family, keeping its naming convention:
    "NxH" = an input dense(2->H) + N hidden dense(H->H), ALL tanh, then a
    linear head (``diode_pretraining.py:113-127`` builds n_layers+2 dense
    layers; C++ parity in ``DiodePairNeuralModel.h:8-40``).  So "2x16" has
    three tanh layers of width 16.  Returns (sizes, activations)."""
    sizes = [d_in] + [layer_size] * (n_layers + 1) + [d_out]
    activations = tuple(["tanh"] * (n_layers + 1) + [""])
    return sizes, activations


@dataclasses.dataclass(eq=False)
class NeuralDiodeRoot(Root):
    """MLP-backed WDF root: b = -MLP([a, log R]).

    ``activations`` defaults to the reference family (all-tanh hidden, linear
    head) but can be overridden, e.g. when loading a JSON model that mixes
    relu/tanh (the DenseRootModel loader supports both, ``layers.py:65-70``).
    """

    name: str = "nn_root"
    n_layers: int = 2
    layer_size: int = 16
    activations: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.activations:
            _, self.activations = mlp_arch(self.n_layers, self.layer_size)

    def init_params(self, key=None) -> Dict[str, MLPParams]:
        if key is None:
            key = jax.random.PRNGKey(0)
        sizes, _ = mlp_arch(self.n_layers, self.layer_size)
        return {self.name: mlp_init(key, sizes)}

    def reflect(self, a, R, params, controls):
        log_r = jnp.log(R) * jnp.ones_like(a)
        x = jnp.stack([a, log_r], axis=-1)
        out = mlp_apply(params[self.name], self.activations, x)[..., 0]
        return -out

    @classmethod
    def from_mlp(cls, name: str, mlp_params: MLPParams, activations: Sequence[str]):
        """Build a root around existing MLP params (e.g. loaded from the JSON
        model zoo); returns (root, params-fragment)."""
        n_hidden = len(mlp_params["layers"]) - 2  # "NxH" naming, see mlp_arch
        width = mlp_params["layers"][0]["kernel"].shape[1]
        root = cls(
            name=name,
            n_layers=n_hidden,
            layer_size=int(width),
            activations=tuple(activations),
        )
        return root, {name: mlp_params}
