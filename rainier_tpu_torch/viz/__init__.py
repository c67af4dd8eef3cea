from .plots import (coeftab, contour, density, hdpi, line, lines, load_csv,
                    mean, precis, scatter, shade, show, standardize, stddev,
                    whiskers)

__all__ = ["coeftab", "contour", "density", "hdpi", "line", "lines",
           "load_csv", "mean", "precis", "scatter", "shade", "show",
           "standardize", "stddev", "whiskers"]
