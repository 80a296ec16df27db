"""Analysis tasks of the main path: m-mode transforms, regridding and map making."""
