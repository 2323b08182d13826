"""The benchmark's own code: manifest, traffic, weights, work counts, the
profiler's reduction and one driver per kind of configuration.

Nothing here imports JAX or the JAX package; the drivers import the port
(``repro_torch``) inside their functions, so the tests can load every
module without a card.
"""
