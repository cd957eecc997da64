"""GNSS system descriptors — this framework's equivalent of GNSSSignals.jl systems.

The reference resolves `"GPSL1"/"GPSL5"` through `GNSSDICT`
(`/root/reference/src/GPUAcceleratedTracking.jl:39-42`) into GNSSSignals.jl system
objects whose `.codes` matrix lives on the GPU. Here a system is a frozen Python
descriptor holding the host-side numpy code table plus the scalar constants; device
placement happens when the table enters a jitted computation (XLA transfers it once
and caches it as a constant or donated argument).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import beidou_b1i, galileo_e1, glonass_l1, gpsl1, gpsl5


@dataclasses.dataclass(frozen=True)
class GNSSSystem:
    """Immutable GNSS signal description.

    Attributes:
      name: registry name, e.g. ``"GPSL1"``.
      codes: ``[code_length, num_prns]`` float32 matrix of +/-1 chips.
      code_frequency: chipping rate in chips/s.
      center_frequency: nominal carrier in Hz.
      code_length: chips per primary code period.
      codes_per_ms: primary code periods per millisecond (1 for L1 C/A and L5).
      secondary_code: optional +/-1 overlay, one sign per primary period.
    """

    name: str
    codes: np.ndarray
    code_frequency: float
    center_frequency: float
    code_length: int
    codes_per_ms: int = 1
    secondary_code: np.ndarray | None = None

    @property
    def num_prns(self) -> int:
        return self.codes.shape[1]

    def code_period(self) -> float:
        return self.code_length / self.code_frequency


@functools.lru_cache(maxsize=None)
def GPSL1() -> GNSSSystem:
    return GNSSSystem(
        name="GPSL1",
        codes=gpsl1.code_table(),
        code_frequency=gpsl1.CODE_FREQUENCY,
        center_frequency=gpsl1.CENTER_FREQUENCY,
        code_length=gpsl1.CODE_LENGTH,
    )


@functools.lru_cache(maxsize=None)
def GPSL5(quadrature: bool = False, with_secondary: bool = True) -> GNSSSystem:
    return GNSSSystem(
        name="GPSL5",
        codes=gpsl5.code_table(quadrature),
        code_frequency=gpsl5.CODE_FREQUENCY,
        center_frequency=gpsl5.CENTER_FREQUENCY,
        code_length=gpsl5.CODE_LENGTH,
        secondary_code=gpsl5.neuman_hofman(quadrature) if with_secondary else None,
    )


@functools.lru_cache(maxsize=None)
def GLONASSL1() -> GNSSSystem:
    """GLONASS L1OF: FDMA, shared 511-chip m-sequence, 1 ms period.

    The ``prn`` column index is the FDMA frequency-channel slot (``k + 7`` for
    channel ``k``); use `glonass_l1.carrier_frequency(k)` for the per-channel
    carrier. Columns are identical — satellite separation is in frequency.
    """
    return GNSSSystem(
        name="GLONASSL1",
        codes=glonass_l1.code_table(),
        code_frequency=glonass_l1.CODE_FREQUENCY,
        center_frequency=glonass_l1.CENTER_FREQUENCY,
        code_length=glonass_l1.CODE_LENGTH,
    )


@functools.lru_cache(maxsize=None)
def GalileoE1(pilot: bool = False, with_secondary: bool = True) -> GNSSSystem:
    """Galileo E1 OS as a BOC(1,1)-expanded code system (4th family).

    The subcarrier meander is folded into the code table (half-chip pairs
    ``(+c, -c)``): code_length 8184 half-chips at 2.046 Mcps, 4 ms primary
    period — phase units are HALF-chips (divide by 2 for ICD chips), and
    every correlator kernel works unchanged at doubled transition density.
    ``pilot=True`` = E1-C (dataless, CS25 overlay — track with the atan2
    PLL discriminator); else E1-B (data). Primary codes are documented
    STAND-INS for the ICD memory tables — see `models.galileo_e1`.
    """
    return GNSSSystem(
        name="GALILEOE1C" if pilot else "GALILEOE1B",
        codes=galileo_e1.code_table(pilot),
        code_frequency=galileo_e1.CODE_FREQUENCY,
        center_frequency=galileo_e1.CENTER_FREQUENCY,
        code_length=galileo_e1.CODE_LENGTH,
        secondary_code=(
            galileo_e1.secondary_code() if pilot and with_secondary else None
        ),
    )


@functools.lru_cache(maxsize=None)
def BeiDouB1I(with_secondary: bool = True) -> GNSSSystem:
    """BeiDou B1I (5th family): 2046-chip register-generated codes, 1 ms period.

    Exactly GPS L1's block cadence at double the chip rate (2.046 Mcps).
    D1 satellites (PRN >= 6) carry the NH20 overlay — the same published
    sequence as GPS L5's Q5 pilot — wired through the standard
    secondary-sync/wipe-off path; pass ``with_secondary=False`` for the
    GEO (D2, PRN 1..5) satellites, which have no overlay.
    """
    return GNSSSystem(
        name="BEIDOUB1I",
        codes=beidou_b1i.code_table(),
        code_frequency=beidou_b1i.CODE_FREQUENCY,
        center_frequency=beidou_b1i.CENTER_FREQUENCY,
        code_length=beidou_b1i.CODE_LENGTH,
        secondary_code=beidou_b1i.secondary_code() if with_secondary else None,
    )


# Name -> constructor registry (equivalent of the reference's GNSSDICT).
GNSS_REGISTRY = {
    "GPSL1": GPSL1,
    "GPSL5": GPSL5,
    "GLONASSL1": GLONASSL1,
    "GALILEOE1B": GalileoE1,
    "GALILEOE1C": functools.partial(GalileoE1, pilot=True),
    "BEIDOUB1I": BeiDouB1I,
}


def get_system(name: str) -> GNSSSystem:
    try:
        return GNSS_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"Unknown GNSS system {name!r}; known: {sorted(GNSS_REGISTRY)}"
        ) from None
