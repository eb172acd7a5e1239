"""diffwdf — differentiable Wave Digital Filters in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
project ``jatinchowdhury18/differentiable-wdfs`` (see SURVEY.md at the repo
root): differentiable WDF circuit simulation and training, analytic
Wright-omega diode roots, trainable neural diode roots with JSON weight
interchange, the full circuit zoo, and batched/sharded execution.
"""

from .core.elements import (
    Resistor,
    Capacitor,
    Inductor,
    ResistiveVoltageSource,
    ResistiveCurrentSource,
    voltage,
    current,
)
from .core.adaptors import Series, Parallel, Inverter
from .core.circuit import Circuit, Root, IdealVoltageSourceRoot, OpenCircuitRoot
from .roots.omega import wright_omega
from .roots.diode import (
    DiodeConfig,
    DiodePairRoot,
    default_diode,
    diode_1n4148_1u1d,
    diode_1n4148_1u2d,
    diode_1n4148_1u3d,
    diode_1n4148_2u2d,
    diode_1n4148_2u3d,
    diode_1n4148_3u3d,
    diode_oa1154_1u1d,
    diode_pair_reflected,
    diode_pair_reflected_symmetric,
    shockley_current,
)
from .roots.neural import NeuralDiodeRoot, mlp_init, mlp_apply, mlp_arch
from .nn.serialization import load_model_json, save_model_json

__version__ = "0.1.0"
