"""Rendering: orthographic rasteriser and two-hand renderer."""
