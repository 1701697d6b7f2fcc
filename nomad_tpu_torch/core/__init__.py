"""Server-side core (reference: nomad_tpu.core).  Ported so far: the
decision records (`explain`) and the observability planes
(`obsbus`, `telemetry`, `memledger`, `logging`, `profiling`,
`timeline`, `flightrec`, `identity`).  Nothing is imported here: the
reference's package imports its server, which the port does not have
yet."""
