"""Bilingual (EN/NL) user-facing strings.

Copy of uvtrace/i18n.py, kept equal to it by tests/test_torch_io_viz.py.

The reference UI is fully bilingual — every label in userinterface.cpp is an
`english ? "..." : "..."` pair (userinterface.cpp:42-408, toggled by a flag).
The CLI mirrors that: `--lang nl` switches the printed strings; the Dutch
terms match the reference's route-XML vocabulary (aantal_fotonen,
lamp_sterkte, minimale_dosis, ... — raytracer.cpp:233-300).
"""

from __future__ import annotations

_STRINGS = {
    "progress": {"en": "Progress", "nl": "Voortgang"},
    "photon_count": {"en": "photon count", "nl": "aantal fotonen"},
    "iteration": {"en": "iteration", "nl": "iteratie"},
    "delta_time": {"en": "delta time", "nl": "delta tijd"},
    "total_time": {"en": "total time", "nl": "totale tijd"},
    "triangles": {"en": "triangles", "nl": "driehoeken"},
    "computing": {"en": "Computing UV radiation", "nl": "UV straling berekenen"},
    "done": {"en": "done", "nl": "klaar"},
    "dose_max": {"en": "max dose (mJ/cm^2)", "nl": "maximale dosis (mJ/cm^2)"},
    "dose_mean": {"en": "mean dose (mJ/cm^2)", "nl": "gemiddelde dosis (mJ/cm^2)"},
    "coverage": {
        "en": "fraction above minimum dose",
        "nl": "fractie boven minimale dosis",
    },
    "calibrated_power": {
        "en": "calibrated lamp power (W)",
        "nl": "gekalibreerde lampsterkte (W)",
    },
    "route_saved": {"en": "route saved to", "nl": "route opgeslagen in"},
    "error": {"en": "error", "nl": "fout"},
    "legend_title": {
        "en": "cumulative dose (mJ/cm^2)",
        "nl": "cumulatieve dosis (mJ/cm^2)",
    },
}

_LANG = "en"


def set_language(lang: str) -> None:
    """Set the active language ('en' or 'nl') — the CLI's --lang flag; the
    reference toggles the same way at runtime (userinterface.cpp `english`)."""
    global _LANG
    if lang not in ("en", "nl"):
        raise ValueError(f"unsupported language: {lang!r} (en|nl)")
    _LANG = lang


def tr(key: str) -> str:
    """Translate a string key in the active language."""
    return _STRINGS[key][_LANG]
