"""Geodetic → local-frame conversion for GPS/NavSat ingest.

Host-side numpy counterpart of the reference's
`cartographer_ros/msg_conversion.cc` `LatLongAltToEcef` (WGS84
geodetic→ECEF) and `ComputeLocalFrameFromLatLong` (a local frame anchored
at a reference lat/long whose +z is the local up direction), plus the
first-fix-anchored conversion policy of
`sensor_bridge.cc:87-111 HandleNavSatFixMessage`: the first fix defines the
ECEF→local transform; every fix thereafter becomes a local-frame position
fed to the pose graph as a fixed-frame (GPS) observation.

Everything here is double-precision numpy — geodetic math at Earth radii
needs f64, and this is a host ingest path (no device compute). A copy of
dliom_tpu/io/geodesy.py, plus the anchor's state for the live checkpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# WGS84 (msg_conversion.cc LatLongAltToEcef constants)
_A = 6378137.0  # semi-major axis, equator to center
_F = 1.0 / 298.257223563
_B = _A * (1.0 - _F)  # semi-minor axis, pole to center
_E_SQ = (_A * _A - _B * _B) / (_A * _A)


def lat_long_alt_to_ecef(
    latitude: float, longitude: float, altitude: float
) -> np.ndarray:
    """WGS84 geodetic (degrees, meters) → ECEF (meters)."""
    phi = np.deg2rad(latitude)
    lam = np.deg2rad(longitude)
    sin_phi, cos_phi = np.sin(phi), np.cos(phi)
    n = _A / np.sqrt(1.0 - _E_SQ * sin_phi * sin_phi)
    return np.asarray(
        [
            (n + altitude) * cos_phi * np.cos(lam),
            (n + altitude) * cos_phi * np.sin(lam),
            (_B * _B / (_A * _A) * n + altitude) * sin_phi,
        ],
        np.float64,
    )


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)


def compute_local_frame_from_lat_long(
    latitude: float, longitude: float
) -> Tuple[np.ndarray, np.ndarray]:
    """ECEF→local transform (rotation matrix R, translation t) anchored at
    (latitude, longitude): `local = R @ ecef + t`, with local +z the up
    direction at the anchor and the anchor's surface point at the origin
    (ComputeLocalFrameFromLatLong)."""
    t_ecef = lat_long_alt_to_ecef(latitude, longitude, 0.0)
    rot = _rot_y(np.deg2rad(latitude - 90.0)) @ _rot_z(np.deg2rad(-longitude))
    return rot, rot @ -t_ecef


class NavSatConverter:
    """First-fix-anchored NavSat→local conversion (sensor_bridge.cc:97-110):
    the first fix fixes the ECEF→local frame; `to_local` then maps any
    geodetic fix into that frame."""

    def __init__(self) -> None:
        self._rot: Optional[np.ndarray] = None
        self._trans: Optional[np.ndarray] = None

    @property
    def anchored(self) -> bool:
        return self._rot is not None

    def to_local(
        self, latitude: float, longitude: float, altitude: float
    ) -> np.ndarray:
        if self._rot is None:
            self._rot, self._trans = compute_local_frame_from_lat_long(
                latitude, longitude
            )
        ecef = lat_long_alt_to_ecef(latitude, longitude, altitude)
        return self._rot @ ecef + self._trans

    def anchor(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The ECEF->local transform fixed by the first fix, or None."""
        return None if self._rot is None else (self._rot.copy(), self._trans.copy())

    @classmethod
    def from_anchor(cls, rot: np.ndarray, trans: np.ndarray) -> "NavSatConverter":
        out = cls()
        out._rot = np.asarray(rot, np.float64)
        out._trans = np.asarray(trans, np.float64)
        return out
