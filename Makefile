# go_tfhe_jax build/test targets (reference analogue: /root/reference/Makefile)

PY ?= python

.PHONY: test test-quick test-slow test-gpu bench smoke examples entry-check lint

test:            ## default tier (CPU, 8 virtual devices; excludes slow+production)
	$(PY) -m pytest tests/ -q

test-quick:      ## alias of the default tier
	$(PY) -m pytest tests/ -q

test-slow:       ## long-running tests incl. production parameter sets
	$(PY) -m pytest tests/ -q -m "slow or production" --override-ini addopts=

test-gpu:        ## card-only tests (marker `gpu`), e.g. production noise margins
	JAX_PLATFORMS=cuda,cpu $(PY) -m pytest tests/ -m gpu -q \
	  --override-ini addopts= -v

smoke:           ## main path on one GPU vs the plain reference (chip_smoke.py)
	$(PY) chip_smoke.py

bench:           ## headline benchmark (one JSON line)
	$(PY) bench.py

examples:        ## run all examples on the small test profiles
	$(PY) examples/simple_gates.py
	$(PY) examples/programmable_bootstrap.py
	$(PY) examples/add_two_numbers.py --batch 2
	$(PY) examples/proxy_reencryption.py
	$(PY) examples/manylut_adder.py --batch 2

entry-check:     ## driver entry points: compile check + multichip dry run
	$(PY) __graft_entry__.py

bench-micro:     ## per-op micro-benchmarks (keygen/enc/dec/PBS/proxy)
	$(PY) bench_micro.py

profile:         ## trace the 128bit_fast bootstrap; device time per kernel class
	$(PY) tools/profile_step.py

warm:            ## pre-populate the persistent XLA compilation cache for the
	         ## production profiles (first-ever compile of the 700-step loop
	         ## takes minutes; afterwards every process start is seconds)
	$(PY) tools/warm_cache.py

CACHE_TARBALL ?= go_tfhe_jax_xla_cache.tar.gz
warm-pack:       ## warm, then pack the cache into a relocatable artifact
	$(PY) tools/warm_cache.py --pack $(CACHE_TARBALL)

warm-unpack:     ## install a packed cache artifact on a fresh host
	$(PY) tools/warm_cache.py --unpack $(CACHE_TARBALL)

security:        ## regenerate the SECURITY.md estimate table
	$(PY) tools/security_estimate.py
