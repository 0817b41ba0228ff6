"""The port's own copies of the parts of the simulator it uses: hardware
constants of the H100 (``hw``) and the calibration fit and measured-table
backend (``backends``)."""
