"""Visualization: trajectory summary panels, envelope maps, 3D animation and
a self-contained HTML viewer (numpy; matplotlib imported by the functions
that draw)."""

from .animate import animate_landing, draw_frame
from .html_viewer import export_html
from .plots import motor_voltages, plot_envelope, plot_results

__all__ = [
    "export_html",
    "plot_results",
    "plot_envelope",
    "motor_voltages",
    "animate_landing",
    "draw_frame",
]
