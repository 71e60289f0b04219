"""Request spans (obs.trace) and always-on latency attribution
(obs.latattr, over obs.histogram's LogHistogram)."""
