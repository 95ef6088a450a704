"""Detector description: JSON -> struct-of-arrays channel tables.

The reference wraps a tinydb JSON database in accessor classes
(NuRadioReco/detector/detector_base.py:131-1082, generic_detector.py:15-565
for reference-station defaulting). This build parses the same JSON schema
once on the host into flat numpy arrays per station — the form every device
kernel consumes. Field conventions follow detector_base.py: positions in
meters (get_relative_position:557-582), orientations in degrees in the JSON
converted to radians (get_antenna_orientation:792-813), cable delay in ns
(get_cable_delay:722-742), ADC sampling frequency in GHz
(get_sampling_frequency:883-897).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np

from nuradiomc_tpu.utils import units


@dataclasses.dataclass
class ChannelArrays:
    """Per-channel detector description of one station (host-side numpy)."""

    channel_ids: np.ndarray         # (C,) int
    positions: np.ndarray           # (C, 3) relative to station, m
    orientation_theta: np.ndarray   # (C,) rad
    orientation_phi: np.ndarray     # (C,) rad
    rotation_theta: np.ndarray      # (C,) rad
    rotation_phi: np.ndarray        # (C,) rad
    cable_delay: np.ndarray         # (C,) ns
    n_samples: np.ndarray           # (C,) int — ADC readout samples
    sampling_frequency: np.ndarray  # (C,) GHz — ADC sampling frequency
    antenna_model: list             # (C,) str
    amp_type: list                  # (C,) str
    noise_temperature: np.ndarray   # (C,) K (nan if undefined)
    adc_nbits: np.ndarray           # (C,) int (-1 if undefined)
    trigger_channels: Optional[np.ndarray] = None  # indices of trigger channels


@dataclasses.dataclass
class Station:
    station_id: int
    absolute_position: np.ndarray  # (3,) easting/northing/altitude, m
    channels: ChannelArrays
    site: str = ""


# geographic coordinates of the known sites (lat, east lon in deg)
SITE_COORDINATES = {
    "southpole": (-90.0, 0.0),
    "mooresbay": (-78.74, 165.02),
    "summit": (72.57, -38.46),
    "auger": (-35.10, -69.30),
    "lofar": (52.91, 6.87),
    "ska": (-26.825, 116.764),
    "greenland": (72.57, -38.46),
}


_CHANNEL_DEFAULTS: dict[str, Any] = {
    "cab_time_delay": 0.0,
    "noise_temperature": np.nan,
    "adc_nbits": -1,
    "amp_type": "",
}


def _get(channel: dict, ref_channel: Optional[dict], key: str):
    """Field lookup with GenericDetector-style reference-channel defaulting
    (generic_detector.py:389-436)."""
    if key in channel and channel[key] is not None:
        return channel[key]
    if ref_channel is not None and key in ref_channel and ref_channel[key] is not None:
        return ref_channel[key]
    if key in _CHANNEL_DEFAULTS:
        return _CHANNEL_DEFAULTS[key]
    raise KeyError(f"channel field '{key}' missing and no reference value available")


class Detector:
    """JSON-backed detector description (GenericDetector semantics).

    Parameters
    ----------
    source : str | dict
        Path to a detector JSON file, or the parsed dict. Schema: top-level
        keys ``channels`` / ``stations`` keyed by arbitrary indices, matching
        the reference tinydb export (see e.g. reference
        test/Veff/dipole_100m.json).
    default_station : int, optional
        Station id whose channels act as the reference for missing fields.
    """

    def __init__(self, source, default_station: Optional[int] = None):
        if isinstance(source, str):
            if source.endswith((".db", ".sqlite", ".sqlite3")):
                # SQL backend (reference detector.py:114-118 source="sql"):
                # buffer the relational DB into the dict format
                from nuradiomc_tpu.detector.detector_sql import SQLDetector
                db = SQLDetector(source).buffer()
            else:
                with open(source) as f:
                    db = json.load(f)
        else:
            db = source

        self._stations_raw = list(db.get("stations", {}).values())
        self._channels_raw = list(db.get("channels", {}).values())
        self._ref_station_id = default_station
        self._build()

    @staticmethod
    def _parse_time(value):
        """tinydb-serialization TinyDate strings / datetimes -> datetime."""
        import datetime as _dt
        if value is None:
            return None
        if isinstance(value, _dt.datetime):
            return value
        s = str(value)
        if s.startswith("{TinyDate}:"):
            s = s[len("{TinyDate}:"):]
        try:
            return _dt.datetime.fromisoformat(s)
        except ValueError:
            return None

    def update(self, time):
        """Set the detector time: only stations/channels whose commission /
        decommission period contains ``time`` are served
        (detector_base.update + _query_station/_query_channels:280-310)."""
        self._build(time=time)

    def _commissioned(self, entry, time):
        if time is None:
            return True
        t0 = self._parse_time(entry.get("commission_time"))
        t1 = self._parse_time(entry.get("decommission_time"))
        return (t0 is None or t0 <= time) and (t1 is None or time < t1)

    def _build(self, time=None):
        stations_raw = [st for st in self._stations_raw
                        if self._commissioned(st, time)]
        channels_raw = [ch for ch in self._channels_raw
                        if self._commissioned(ch, time)]
        default_station = self._ref_station_id

        self._stations: dict[int, Station] = {}

        by_station: dict[int, list[dict]] = {}
        self._raw_channels: dict[tuple[int, int], dict] = {}
        for ch in channels_raw:
            by_station.setdefault(int(ch["station_id"]), []).append(ch)
            self._raw_channels[(int(ch["station_id"]), int(ch["channel_id"]))] = ch

        ref_channels = by_station.get(default_station, [None])
        ref_channel = ref_channels[0] if ref_channels else None

        for st in stations_raw:
            sid = int(st["station_id"])
            chs = sorted(by_station.get(sid, []), key=lambda c: int(c["channel_id"]))
            if not chs and st.get("reference_station") is not None:
                # GenericDetector: a station without own channels serves the
                # channels of its reference station (generic_detector.py
                # reference-station defaulting)
                ref_sid = int(st["reference_station"])
                chs = [dict(c, station_id=sid)
                       for c in sorted(by_station.get(ref_sid, []),
                                       key=lambda c: int(c["channel_id"]))]
                for c in chs:
                    self._raw_channels[(sid, int(c["channel_id"]))] = c
            if not chs:
                continue
            n = len(chs)
            arr = ChannelArrays(
                channel_ids=np.array([int(c["channel_id"]) for c in chs]),
                positions=np.array([[_get(c, ref_channel, "ant_position_x"),
                                     _get(c, ref_channel, "ant_position_y"),
                                     _get(c, ref_channel, "ant_position_z")] for c in chs],
                                   dtype=float),
                orientation_theta=np.deg2rad([_get(c, ref_channel, "ant_orientation_theta") for c in chs]),
                orientation_phi=np.deg2rad([_get(c, ref_channel, "ant_orientation_phi") for c in chs]),
                rotation_theta=np.deg2rad([_get(c, ref_channel, "ant_rotation_theta") for c in chs]),
                rotation_phi=np.deg2rad([_get(c, ref_channel, "ant_rotation_phi") for c in chs]),
                cable_delay=np.array([_get(c, ref_channel, "cab_time_delay") for c in chs], dtype=float),
                n_samples=np.array([int(_get(c, ref_channel, "adc_n_samples")) for c in chs]),
                sampling_frequency=np.array([_get(c, ref_channel, "adc_sampling_frequency") for c in chs],
                                            dtype=float) * units.GHz,
                antenna_model=[_get(c, ref_channel, "ant_type") for c in chs],
                amp_type=[str(_get(c, ref_channel, "amp_type")) for c in chs],
                noise_temperature=np.array([float(_get(c, ref_channel, "noise_temperature"))
                                            for c in chs]),
                adc_nbits=np.array([int(_get(c, ref_channel, "adc_nbits") or -1) for c in chs]),
            )
            abs_pos = np.array([st.get("pos_easting", 0.0) or 0.0,
                                st.get("pos_northing", 0.0) or 0.0,
                                st.get("pos_altitude", 0.0) or 0.0], dtype=float)
            self._stations[sid] = Station(sid, abs_pos, arr,
                                          site=str(st.get("pos_site", "")))

    # -- accessors mirroring the reference API (detector_base.py) -----------

    def get_station_ids(self):
        return sorted(self._stations)

    def has_station(self, station_id):
        return int(station_id) in self._stations

    def get_reference_station_ids(self):
        """GenericDetector API: the station id(s) used for field defaulting."""
        return [self._ref_station_id] if self._ref_station_id is not None else []

    def add_generic_station(self, station_dict):
        """Add a station on the fly (generic_detector.add_generic_station):
        channels come from ``reference_station`` unless provided separately."""
        self._stations_raw.append(dict(station_dict))
        self._build()

    def add_station_properties_for_event(self, properties, station_id,
                                         run_number, event_id):
        """Per-event station property overrides
        (generic_detector.add_station_properties_for_event)."""
        if not hasattr(self, "_event_properties"):
            self._event_properties = {}
        self._event_properties.setdefault((run_number, event_id), {})[
            int(station_id)] = dict(properties)

    def set_event(self, run_number, event_id):
        """Apply the per-event station overrides registered for
        (run_number, event_id) (generic_detector.set_event)."""
        overrides = getattr(self, "_event_properties", {}).get(
            (run_number, event_id), {})
        for sid, props in overrides.items():
            if sid in self._stations:
                st = self._stations[sid]
                st.absolute_position = np.array([
                    props.get("pos_easting", st.absolute_position[0]),
                    props.get("pos_northing", st.absolute_position[1]),
                    props.get("pos_altitude", st.absolute_position[2]),
                ], dtype=float)

    def get_channel(self, station_id: int, channel_id: int) -> dict:
        """Raw channel description dict (detector_base.get_channel)."""
        return self._raw_channels[(int(station_id), int(channel_id))]

    def get_station(self, station_id: int) -> Station:
        return self._stations[station_id]

    def get_channel_ids(self, station_id: int):
        return list(self._stations[station_id].channels.channel_ids)

    def get_absolute_position(self, station_id: int):
        return self._stations[station_id].absolute_position

    def get_relative_position(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return ch.positions[idx]

    def get_antenna_orientation(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return np.array([ch.orientation_theta[idx], ch.orientation_phi[idx],
                         ch.rotation_theta[idx], ch.rotation_phi[idx]])

    def get_cable_delay(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return ch.cable_delay[idx]

    def get_number_of_samples(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return int(ch.n_samples[idx])

    def get_sampling_frequency(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return ch.sampling_frequency[idx]

    def get_antenna_model(self, station_id: int, channel_id: int):
        ch = self._stations[station_id].channels
        idx = int(np.where(ch.channel_ids == channel_id)[0][0])
        return ch.antenna_model[idx]

    def get_channel_group_id(self, station_id: int, channel_id: int):
        """Group id of a channel; falls back to the channel id when the
        description carries none (detector_base.get_channel_group_id:957-977).
        Used to pair orthogonally-polarized antennas sharing one structure."""
        ch = self._raw_channels.get((int(station_id), int(channel_id)), {})
        gid = ch.get("channel_group_id")
        return int(channel_id) if gid is None else int(gid)

    def get_site(self, station_id: int) -> str:
        """Site name (detector_base.get_site)."""
        return self._stations[station_id].site

    def get_site_coordinates(self, station_id: int):
        """(latitude, east longitude) in degrees
        (detector_base.get_site_coordinates)."""
        return SITE_COORDINATES[self.get_site(station_id)]


class DetectorSysUncertainties(Detector):
    """Detector wrapper with systematic-uncertainty offsets on antenna
    orientations and positions (detector_sys_uncertainties.py:8-172).

    Offsets apply to all stations/channels unless (station_id, channel_id)
    specific offsets are set; specific offsets win over global ones.
    """

    def __init__(self, source, default_station=None):
        super().__init__(source, default_station)
        self._ori_offsets: dict = {}
        self._pos_offsets: dict = {}

    def set_antenna_orientation_offsets(self, ori_theta, ori_phi, rot_theta,
                                        rot_phi, station_id=None,
                                        channel_id=None):
        self._ori_offsets[(station_id, channel_id)] = np.array(
            [ori_theta, ori_phi, rot_theta, rot_phi], dtype=float)

    def reset_antenna_orientation_offsets(self):
        self._ori_offsets = {}

    def set_antenna_position_offsets(self, x, y, z, station_id=None,
                                     channel_id=None):
        self._pos_offsets[(station_id, channel_id)] = np.array(
            [x, y, z], dtype=float)

    def reset_antenna_position_offsets(self):
        self._pos_offsets = {}

    def _lookup(self, table, station_id, channel_id):
        for key in ((station_id, channel_id), (station_id, None),
                    (None, channel_id), (None, None)):
            if key in table:
                return table[key]
        return None

    def get_antenna_orientation(self, station_id, channel_id):
        ori = np.array(super().get_antenna_orientation(station_id, channel_id))
        off = self._lookup(self._ori_offsets, station_id, channel_id)
        return tuple(ori + off) if off is not None else tuple(ori)

    def get_relative_position(self, station_id, channel_id):
        pos = np.array(super().get_relative_position(station_id, channel_id))
        off = self._lookup(self._pos_offsets, station_id, channel_id)
        return pos + off if off is not None else pos
