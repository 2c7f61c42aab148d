# proteus_jax container: DSWx-HLS SAS
# (the science chain runs on an NVIDIA GPU when a CUDA-enabled jax is
# installed; this image defaults to jax[cpu] for portability)
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ zlib1g-dev && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/proteus_jax
COPY . .
RUN pip install --no-cache-dir numpy scipy pytest "jax[cpu]" \
    && pip install --no-cache-dir . \
    && python -m proteus_jax.native.build

ENTRYPOINT ["dswx_hls"]
