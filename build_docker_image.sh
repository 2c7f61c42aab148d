#!/bin/sh
# Build the proteus_jax container image and run the test suite inside it.
set -e
IMAGE=${1:-proteus_jax}
docker build -t "$IMAGE" .
docker run --rm --entrypoint python "$IMAGE" -m pytest /opt/proteus_jax/tests -q
