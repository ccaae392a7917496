"""The observability master switch.

One module-level flag shared by ``obs.trace`` and ``obs.metrics`` so a
single attribute load decides whether an instrumentation call does any
work.  Default **off**: tier-1 tests and production hot paths pay one
``if not state.enabled: return`` per call site and nothing else.  Flip
it through ``obs.configure`` (or the scoped ``obs.enabled()`` context
manager), never by assigning here directly from user code.
"""

enabled: bool = False
