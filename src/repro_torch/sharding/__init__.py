"""Sharding rules of the production mesh, as pure shape math
(``rules.py``): which mesh axes each leaf of a parameter, optimizer
state, batch or cache tree is split over, and the bytes one device then
holds."""
