"""EXTENT core of the port: the device/circuit calibration, the priority
API, the EXTENT table and the serving energy accounting."""
