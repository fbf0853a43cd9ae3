# Developer entry points (see CLAUDE.md for details).

.PHONY: test test-clean native bench

# full suite via the known-good chunked procedure (scripts/run_suite.py)
test:
	python scripts/run_suite.py

# same, but wipe the persistent compile cache first (hang/SEGFAULT recovery)
test-clean:
	python scripts/run_suite.py --clean-cache

native:
	$(MAKE) -C scl_slam/native

bench:
	python bench.py
