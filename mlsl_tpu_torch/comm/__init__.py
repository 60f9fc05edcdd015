"""Collective communication over virtual ranks: mesh, collectives, requests and
the int8 ring."""
