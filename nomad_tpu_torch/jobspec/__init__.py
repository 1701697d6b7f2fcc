"""Jobspec helpers (reference: nomad_tpu.jobspec).  Ported so far: the
duration parser the struct codec needs (`schema`) and the HCL parser
and evaluator (`hcl`), which the ACL policy parser reads."""
