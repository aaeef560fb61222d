"""What the flyability evaluation needs of the ADS-B preprocessing: the
airport table, the airport lookup and the vectorised haversine.

A copy of the parts of ``tvqvae_tpu/data/preprocess.py`` that flyability
reads (``AIRPORTS``, ``airport_latlon``, ``haversine_np``); the rest of that
module (loading, cleaning, clustering and resampling raw flights) is not
ported yet. Airport coordinates come from the built-in table, an explicit
override, or ``traffic.data.airports`` when ``traffic`` is installed.
"""

from typing import Dict, Optional, Tuple

import numpy as np

# Public coordinates of commonly used airports (lat, lon); extend via CLI
# --adep_latlon/--ades_latlon or the optional `traffic` database.
AIRPORTS: Dict[str, Tuple[float, float]] = {
    "EHAM": (52.3086, 4.7639),   # Amsterdam Schiphol
    "LIMC": (45.6306, 8.7281),   # Milan Malpensa
    "ENGM": (60.1939, 11.1004),  # Oslo Gardermoen
    "EGLL": (51.4706, -0.4619),  # London Heathrow
    "EGKK": (51.1481, -0.1903),  # London Gatwick
    "LFPG": (49.0097, 2.5479),   # Paris CDG
    "LFPO": (48.7233, 2.3794),   # Paris Orly
    "LOWW": (48.1103, 16.5697),  # Vienna
    "EDDF": (50.0379, 8.5622),   # Frankfurt
    "EDDM": (48.3538, 11.7861),  # Munich
    "LEMD": (40.4719, -3.5626),  # Madrid
    "LEBL": (41.2971, 2.0785),   # Barcelona
    "LIRF": (41.8003, 12.2389),  # Rome Fiumicino
    "EKCH": (55.6179, 12.6560),  # Copenhagen
    "ESSA": (59.6519, 17.9186),  # Stockholm Arlanda
    "LSZH": (47.4647, 8.5492),   # Zurich
    "EBBR": (50.9014, 4.4844),   # Brussels
    "LPPT": (38.7813, -9.1359),  # Lisbon
    "LGAV": (37.9364, 23.9445),  # Athens
    "EIDW": (53.4213, -6.2701),  # Dublin
    "EDDT": (52.5597, 13.2877),  # Berlin Tegel
    "EDDB": (52.3667, 13.5033),  # Berlin Brandenburg
    "LTFM": (41.2753, 28.7519),  # Istanbul
    "UUEE": (55.9726, 37.4146),  # Moscow Sheremetyevo
    "LIML": (45.4494, 9.2783),   # Milan Linate
    "EHRD": (51.9569, 4.4372),   # Rotterdam
}


def airport_latlon(code: str, override: Optional[Tuple[float, float]] = None):
    if override is not None:
        return tuple(override)
    if code in AIRPORTS:
        return AIRPORTS[code]
    try:  # traffic's airport database, when installed
        from traffic.data import airports as _airports

        return tuple(_airports[code].latlon)
    except Exception:
        raise KeyError(
            f"Unknown airport {code}: pass --adep_latlon/--ades_latlon "
            f"or install the `traffic` library."
        )


def haversine_np(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (vectorized)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 6371.0 * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
