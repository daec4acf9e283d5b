"""The distributed layer (port of ``repro.dist``): sharding rules over a
``DeviceMesh``."""
