"""Analysis functions of the sidereal regrid -> m-mode slice."""
