"""Reference-compatible route/parameter XML persistence.

Numpy copy of uvtrace/io/routexml.py, kept equal to it by tests/test_torch_host.py.

Schema (Dutch tags) per the reference's tinyxml2 writer/reader
(raytracer.cpp:233-300) and positions/route.xml:

    <route>
      <aantal_fotonen>33554432</aantal_fotonen>        photon count
      <aantal_iteraties>10</aantal_iteraties>           iterations
      <lamp_sterkte>443.3</lamp_sterkte>                lamp power (W)
      <minimale_dosis>300</minimale_dosis>              min dose (mJ/cm^2)
      <minimale_bestralingssterkte>1500</...>           min irradiance (µW/cm^2)
      <lamp_lengte>1</lamp_lengte>                      rod length (m)
      <lamp_hoogte>0.6</lamp_hoogte>                    rod base height (m)
      <route>
        <lamp_positie_0 positie_x=".." positie_y=".." duration=".."/>
        ...
      </route>
    </route>

Files written here load in the reference application and vice versa.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from xml.etree import ElementTree as ET


@dataclasses.dataclass
class LightPos:
    """One route waypoint: lamp floor position (x, y) + dwell seconds
    (raytracer.h LightPos: float2 position; float duration)."""

    x: float
    y: float
    duration: float = 1.0


@dataclasses.dataclass
class Route:
    waypoints: list[LightPos] = dataclasses.field(default_factory=list)
    photon_count: int | None = None
    max_iterations: int | None = None
    light_intensity: float | None = None
    min_dosage: float | None = None
    min_power: float | None = None
    light_length: float | None = None
    light_height: float | None = None

    def apply_to(self, params):
        """Overlay the route file's parameters onto a SimParams (the reference
        mutates RayTracer fields in LoadRoute, raytracer.cpp:261-283)."""
        mapping = {
            "photon_count": self.photon_count,
            "max_iterations": self.max_iterations,
            "light_intensity": self.light_intensity,
            "min_dosage": self.min_dosage,
            "min_power": self.min_power,
            "light_length": self.light_length,
            "light_height": self.light_height,
        }
        return dataclasses.replace(
            params, **{k: v for k, v in mapping.items() if v is not None}
        )


def load_route_xml(path: str | Path) -> Route:
    root = ET.parse(str(path)).getroot()

    def _float(tag):
        e = root.find(tag)
        return float(e.text) if e is not None and e.text else None

    def _int(tag):
        e = root.find(tag)
        return int(e.text) if e is not None and e.text else None

    route = Route(
        photon_count=_int("aantal_fotonen"),
        max_iterations=_int("aantal_iteraties"),
        light_intensity=_float("lamp_sterkte"),
        min_dosage=_float("minimale_dosis"),
        min_power=_float("minimale_bestralingssterkte"),
        light_length=_float("lamp_lengte"),
        light_height=_float("lamp_hoogte"),
    )
    inner = root.find("route")
    if inner is not None:
        i = 0
        while True:
            e = inner.find(f"lamp_positie_{i}")
            if e is None:
                break
            route.waypoints.append(
                LightPos(
                    x=float(e.get("positie_x", 0.0)),
                    y=float(e.get("positie_y", 0.0)),
                    duration=float(e.get("duration", 1.0)),
                )
            )
            i += 1
    return route


def _fmt(v: float) -> str:
    """Compact float formatting like tinyxml2's %.9g for attribute values."""
    return f"{v:.9g}"


def save_route_xml(path: str | Path, route: Route) -> None:
    root = ET.Element("route")
    for tag, val in [
        ("aantal_fotonen", route.photon_count),
        ("aantal_iteraties", route.max_iterations),
        ("lamp_sterkte", route.light_intensity),
        ("minimale_dosis", route.min_dosage),
        ("minimale_bestralingssterkte", route.min_power),
        ("lamp_lengte", route.light_length),
        ("lamp_hoogte", route.light_height),
    ]:
        if val is not None:
            e = ET.SubElement(root, tag)
            e.text = _fmt(val) if isinstance(val, float) else str(val)
    inner = ET.SubElement(root, "route")
    for i, wp in enumerate(route.waypoints):
        ET.SubElement(
            inner,
            f"lamp_positie_{i}",
            positie_x=_fmt(wp.x),
            positie_y=_fmt(wp.y),
            duration=_fmt(wp.duration),
        )
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(str(path), encoding="unicode")
