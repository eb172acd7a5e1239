"""Tube Screamer clipping stage — the complex-topology showcase circuit.

Capability parity with the reference
(``plugin/src/dsp/tube_screamer/TubeScreamer.h:24-84`` / ``.cpp:43-66``):

- Port B: (Vin series C2=1uF) || R5=10k        — input network into V+
- Port C: R4=4.7k series C3=47nF               — V- to ground leg
- Port D: RL=1M                                — output load
- 4-port R-type adaptor around an op-amp (gain Ag=100, Rin=1e9, Rout=0.1)
- Port A (adapted): (R6=51k + drive*500k) || C4=51pF, then || the adaptor,
  with the diode pair (analytic or neural 2x16) as the root
- output: voltage across RL; drive pot updates R6 per block.

Where the reference bakes in a symbolic 4x4 scattering matrix generated
offline by R-Solver, we describe the op-amp stage as a 4-node netlist and
derive S numerically (see ``diffwdf.core.rtype``); the derived matrix is
validated against the reference's closed form in tests/test_rtype.py.

Op-amp stage netlist (nodes: 1 = V+, 2 = V-, 3 = op-amp internal source,
4 = output):  Ri from 1-2, Ro from 3-4, VCVS v3 = Ag (v1 - v2);
ports: A = (4,2) across the feedback path, B = (1,0), C = (2,0), D = (4,0).
"""

from __future__ import annotations

from ..core.adaptors import Parallel, Series
from ..core.circuit import Circuit, Root
from ..core.elements import Capacitor, Resistor, ResistiveVoltageSource
from ..core.rtype import (
    Netlist,
    RTypeAdaptor,
    VCVS,
    bake_static_scatter,
    make_netlist_scatter_fn,
)

#: op-amp model constants (``TubeScreamer.h:44-46``)
OPAMP_GAIN = 100.0
OPAMP_RIN = 1.0e9
OPAMP_ROUT = 1.0e-1

#: component values (``TubeScreamer.h:27-37,64-67``)
C2_F = 1.0e-6
R5_OHMS = 10.0e3
R4_OHMS = 4.7e3
C3_F = 0.047e-6
RL_OHMS = 1.0e6
R6_OHMS = 51.0e3
POT1_OHMS = 500.0e3
C4_F = 51.0e-12


def tube_screamer_netlist(
    gain: float = OPAMP_GAIN, rin: float = OPAMP_RIN, rout: float = OPAMP_ROUT
) -> Netlist:
    """The op-amp stage as an R-type internal network (see module docstring).

    Nodes: 1 = V+ (non-inverting input), 2 = V- (inverting input),
    3 = op-amp internal VCVS output, 4 = stage output.  Ri across the inputs,
    Ro in series between VCVS and output, VCVS v3 = gain (v1 - v2).  Ports:
    A = feedback path (V- .. output), B = input network into V+, C = the
    V- ground leg, D = the load.

    Note the **negated Ro**: reverse-engineering the reference's R-Solver
    closed form (``TubeScreamer.h:53-60``) against this netlist shows its
    expressions correspond to an output-resistance branch of value -Ro (every
    Ro cross term enters with flipped sign; with -Ro the derived matrix and
    adapted-port resistance match the reference to ~1e-15, with +Ro they
    differ at O(Ro/Rd)).  We reproduce the reference exactly; at
    Ro = 0.1 Ohm the audible difference is nil either way.
    """
    return Netlist(
        n_nodes=4,
        resistors=((1, 2, rin), (3, 4, -rout)),
        vcvs=(VCVS(out_p=3, out_m=0, ctrl_p=1, ctrl_m=2, gain=gain),),
        ports=((2, 4), (0, 1), (0, 2), (0, 4)),  # A (adapted), B, C, D
    )


def make_tube_screamer(
    root: Root,
    fs: float,
    drive: float = 0.5,
    static_s: bool = True,
) -> Circuit:
    """Build the Tube Screamer circuit.

    Controls: {"Vin": {"v": ...}} per sample; {"R6": {"R": ...}} to move the
    drive pot (R6 + drive * Pot1, reference ``TubeScreamer.cpp:66``).
    ``static_s=True`` bakes the (fixed-component) scattering matrix host-side
    in float64; False derives it inside the traced adaptation pass.
    """
    vin = ResistiveVoltageSource("Vin", R=1.0)
    c2 = Capacitor("C2", C2_F)
    s1 = Series("S1", vin, c2)
    r5 = Resistor("R5", R5_OHMS)
    p1 = Parallel("P1", s1, r5)  # port B

    r4 = Resistor("R4", R4_OHMS)
    c3 = Capacitor("C3", C3_F)
    s2 = Series("S2", r4, c3)  # port C

    rl = Resistor("RL", RL_OHMS)  # port D

    net = tube_screamer_netlist()
    if static_s:
        # child port impedances are fixed given (fs, component values)
        rb = 1.0 / (1.0 / (1.0 + 1.0 / (2.0 * C2_F * fs)) + 1.0 / R5_OHMS)
        rc = R4_OHMS + 1.0 / (2.0 * C3_F * fs)
        rd = RL_OHMS
        radapt = RTypeAdaptor(
            "R", ports=(p1, s2, rl), static_s=bake_static_scatter(net, [rb, rc, rd])
        )
    else:
        radapt = RTypeAdaptor(
            "R", ports=(p1, s2, rl), s_fn=make_netlist_scatter_fn(net)
        )

    r6 = Resistor("R6", R6_OHMS + drive * POT1_OHMS)
    c4 = Capacitor("C4", C4_F)
    p2 = Parallel("P2", r6, c4)
    p3 = Parallel("P3", p2, radapt)

    return Circuit(tree=p3, root=root, fs=fs, outputs=("RL",))


def drive_to_r6(drive: float) -> float:
    """Drive pot position [0,1] -> R6 branch resistance."""
    return R6_OHMS + drive * POT1_OHMS
