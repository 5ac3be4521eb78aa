"""The least time of one multichannel NMF fit on one H100, from its shapes
alone, on the peaks of :mod:`benchmark.harness.roofline`.

The work is what the EM of the FASST local Gaussian model needs (the
equations of :mod:`benchmark.reference.separate`), whatever kernels run it,
for a fit of F bins × N frames of a C-channel mixture into J sources of K
NMF components, n_em iterations of n_inner IS-NMF updates each. Complex
arithmetic is counted in real operations: a complex product 6, a complex
sum 2, a real times a complex 2, a complex multiply-add 8 (as a ``cgemm``
counts it), so a C × C complex matrix product is 8·C³; an elementwise
real operation, floor or reciprocal is 1.

An iteration, each source-bin (J·F·N of them):

- v = W·H at the bin: 2·K;
- v·R: 2·C², and its sum into Σ_x: 2·C²;
- the gain G = v R Σ_x⁻¹: 8·C³;
- the posterior mean ŷ = G x: 8·C², and ŷŷᴴ: 6·C²;
- G·(v R): 8·C³, and R̂ = ŷŷᴴ + v R − G v R: 4·C²;
- the M-step's sum of R̂ / v over n: 4·C² + 1;
- z = Re tr(R⁻¹ R̂) / C, floored: 4·C² + 2.

Each bin (F·N):

- δ = 1e-6·tr(Σ_x)/C + 1e-12 and the ridge: 2·C + 2;
- Σ_x⁻¹ and det Σ_x in closed form at C = 2: the determinant 14, its
  reciprocal 7, the adjugate times it 24, so 45 (8·C³ beyond C = 2);
- the NLL term log det Σ_x + xᴴ Σ_x⁻¹ x: 8·C² + 4·C + 3.

Each source and bin of frequency (J·F), once an iteration: the mean over n,
the Hermitian part, the trace normalization, the ridge and the inverse of
R_j(f), and W's rows times the scale: 8·C² + 2·C + 47 + K.

The IS-NMF updates, each source, n_inner a iteration: W·H twice, the
numerator and denominator of W's update and of H's, 12·F·K·N; the ratios
z ⊘ v̂², v̂^{∘−1} and their floors, twice, 8·F·N; W's update, column sums
and normalization, 4·F·K; H's scale and update, 3·K·N.

Bytes: the mixture's STFT x (F × N × C, complex64) read once an iteration,
since x xᴴ can be formed from it where it is used; W (J × F × K) and H
(J × K × N), float32, and R (J × F × C × C), complex64, read and written
once an iteration. Everything else lives between the steps of one
iteration and is not counted.
"""

from __future__ import annotations


def em_work(F: int, N: int, C: int, J: int, K: int, n_em: int,
            n_inner: int) -> tuple[int, int]:
    """(operations, bytes) of one fit of n_em iterations."""
    c2, c3 = C * C, C * C * C
    source_bin = 2 * K + 16 * c3 + 30 * c2 + 3
    inverse = 45 if C == 2 else 8 * c3
    bin_ = 2 * C + 2 + inverse + 8 * c2 + 4 * C + 3
    source_freq = 8 * c2 + 2 * C + 47 + K
    nmf = 12 * F * K * N + 8 * F * N + 4 * F * K + 3 * K * N
    flops = n_em * (J * F * N * source_bin + F * N * bin_ + J * F * source_freq
                    + J * n_inner * nmf)
    nbytes = n_em * (8 * F * N * C + 2 * (4 * J * F * K + 4 * J * K * N + 8 * J * F * c2))
    return flops, nbytes
