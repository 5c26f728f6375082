// Native molecular-integral engine (McMurchie-Davidson).
//
// C++ replacement for the pyscf C integral core the reference consumes
// through perform_pyscf_computation (reference molecule_factory.py:318-320).
// Same algorithm as openvqe_tpu/chem/integrals.py (which remains the
// cross-checked fallback); this engine accelerates the O(N^4) ERI tensor
// that dominates chemistry setup for the larger molecules of the table
// (SO2/Cl2/CO2, 15-19 AOs).
//
// Exposed via a plain C ABI for ctypes:
//   ovqe_one_electron(...)  -> overlap, kinetic, nuclear-attraction matrices
//   ovqe_eri(...)           -> full (pq|rs) chemist-notation tensor
//
// Shell data layout (flattened, matching chem.basis.Shell):
//   l[s], center[3*s], nprim[s], prim_offset[s], exps[...], coefs[...]
//
// Build: make -C openvqe_tpu/native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LMAX = 2;          // s, p (d headroom)
constexpr int EMAX = 2 * LMAX + 3;

struct Shell {
    int l;
    double cx, cy, cz;
    int nprim;
    const double* exps;
    const double* coefs;
};

// number of cartesian components of angular momentum l
inline int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// cartesian component tables (matches chem.basis.cartesian_components)
static const int CART[3][6][3] = {
    {{0,0,0}},
    {{1,0,0},{0,1,0},{0,0,1}},
    {{2,0,0},{1,1,0},{1,0,1},{0,2,0},{0,1,1},{0,0,2}},
};

// Boys function F_0..F_m via series (small T) or sqrt asymptote + upward
// recursion (large T).
void boys(int m_max, double T, double* F) {
    if (T < 1e-13) {
        for (int m = 0; m <= m_max; ++m) F[m] = 1.0 / (2.0 * m + 1.0);
        return;
    }
    if (T > 35.0) {
        F[0] = 0.5 * std::sqrt(M_PI / T);
        const double eT = std::exp(-T);
        for (int m = 0; m < m_max; ++m)
            F[m + 1] = ((2.0 * m + 1.0) * F[m] - eT) / (2.0 * T);
        return;
    }
    // series at the top order, then downward recursion (always stable)
    double acc = 0.0, term = 1.0 / (2.0 * m_max + 1.0);
    for (int k = 0; k < 200; ++k) {
        acc += term;
        term *= 2.0 * T / (2.0 * m_max + 2.0 * k + 3.0);
        if (term < 1e-17 * acc) break;
    }
    const double eT = std::exp(-T);
    F[m_max] = acc * eT;
    for (int m = m_max - 1; m >= 0; --m)
        F[m] = (2.0 * T * F[m + 1] + eT) / (2.0 * m + 1.0);
}

// Hermite expansion coefficients E[i][j][t] for one axis.
struct EArr {
    double v[LMAX + 1][LMAX + 3][EMAX + 1];
};

void hermite_expansion(int i_max, int j_max, double Q, double a, double b,
                       EArr& E) {
    const double p = a + b, q = a * b / p;
    std::memset(&E, 0, sizeof(E));
    E.v[0][0][0] = std::exp(-q * Q * Q);
    const double inv2p = 0.5 / p, XPA = -b * Q / p, XPB = a * Q / p;
    for (int i = 1; i <= i_max; ++i)
        for (int t = 0; t <= i; ++t) {
            double val = XPA * E.v[i-1][0][t] + (t + 1) * E.v[i-1][0][t+1];
            if (t > 0) val += inv2p * E.v[i-1][0][t-1];
            E.v[i][0][t] = val;
        }
    for (int j = 1; j <= j_max; ++j)
        for (int i = 0; i <= i_max; ++i)
            for (int t = 0; t <= i + j; ++t) {
                double val = XPB * E.v[i][j-1][t] + (t + 1) * E.v[i][j-1][t+1];
                if (t > 0) val += inv2p * E.v[i][j-1][t-1];
                E.v[i][j][t] = val;
            }
}

// Hermite-Coulomb integrals R[t][u][v] up to total order L.
struct RArr {
    int L;
    std::vector<double> data;   // (L+1)^3
    double& at(int t, int u, int v) {
        return data[(t * (L + 1) + u) * (L + 1) + v];
    }
};

void hermite_coulomb(int L, double p, double px, double py, double pz,
                     RArr& R) {
    const double T = p * (px * px + py * py + pz * pz);
    double F[4 * LMAX + 2];
    boys(L, T, F);
    const int n1 = L + 1;
    std::vector<double> Rn((L + 1) * n1 * n1 * n1, 0.0);
    auto idx = [&](int n, int t, int u, int v) {
        return ((n * n1 + t) * n1 + u) * n1 + v;
    };
    double pw = 1.0;
    for (int n = 0; n <= L; ++n) { Rn[idx(n,0,0,0)] = pw * F[n]; pw *= -2.0 * p; }
    for (int total = 1; total <= L; ++total)
        for (int t = 0; t <= total; ++t)
            for (int u = 0; u <= total - t; ++u) {
                int v = total - t - u;
                for (int n = 0; n <= L - total; ++n) {
                    double val;
                    if (t > 0) {
                        val = px * Rn[idx(n+1, t-1, u, v)];
                        if (t > 1) val += (t - 1) * Rn[idx(n+1, t-2, u, v)];
                    } else if (u > 0) {
                        val = py * Rn[idx(n+1, t, u-1, v)];
                        if (u > 1) val += (u - 1) * Rn[idx(n+1, t, u-2, v)];
                    } else {
                        val = pz * Rn[idx(n+1, t, u, v-1)];
                        if (v > 1) val += (v - 1) * Rn[idx(n+1, t, u, v-2)];
                    }
                    Rn[idx(n, t, u, v)] = val;
                }
            }
    R.L = L;
    R.data.assign(n1 * n1 * n1, 0.0);
    for (int t = 0; t <= L; ++t)
        for (int u = 0; u <= L - t; ++u)
            for (int v = 0; v <= L - t - u; ++v)
                R.at(t, u, v) = Rn[idx(0, t, u, v)];
}

// cached per-primitive-pair data for a shell pair
struct PairPrim {
    double p, Px, Py, Pz, coef;
    EArr Ex, Ey, Ez;
};

struct ShellPair {
    int la, lb;
    std::vector<PairPrim> prims;
};

void build_pair(const Shell& A, const Shell& B, ShellPair& sp) {
    sp.la = A.l; sp.lb = B.l;
    sp.prims.resize(A.nprim * B.nprim);
    const double ABx = A.cx - B.cx, ABy = A.cy - B.cy, ABz = A.cz - B.cz;
    int k = 0;
    for (int i = 0; i < A.nprim; ++i)
        for (int j = 0; j < B.nprim; ++j, ++k) {
            const double a = A.exps[i], b = B.exps[j], p = a + b;
            PairPrim& pp = sp.prims[k];
            pp.p = p;
            pp.Px = (a * A.cx + b * B.cx) / p;
            pp.Py = (a * A.cy + b * B.cy) / p;
            pp.Pz = (a * A.cz + b * B.cz) / p;
            pp.coef = A.coefs[i] * B.coefs[j];
            // +2 on ket angular momentum for kinetic reuse
            hermite_expansion(A.l, B.l + 2, ABx, a, b, pp.Ex);
            hermite_expansion(A.l, B.l + 2, ABy, a, b, pp.Ey);
            hermite_expansion(A.l, B.l + 2, ABz, a, b, pp.Ez);
        }
}

std::vector<Shell> unpack_shells(int n_shells, const int32_t* ls,
                                 const double* centers, const int32_t* nprim,
                                 const int32_t* prim_off, const double* exps,
                                 const double* coefs) {
    std::vector<Shell> out(n_shells);
    for (int s = 0; s < n_shells; ++s) {
        out[s] = Shell{ls[s], centers[3*s], centers[3*s+1], centers[3*s+2],
                       nprim[s], exps + prim_off[s], coefs + prim_off[s]};
    }
    return out;
}

inline double kin1d(const EArr& E, int i, int j, double b) {
    double val = b * (2 * j + 1) * E.v[i][j][0] - 2.0 * b * b * E.v[i][j+2][0];
    if (j >= 2) val -= 0.5 * j * (j - 1) * E.v[i][j-2][0];
    return val;
}

}  // namespace

extern "C" {

// one-electron integrals: S, T, V (nbf x nbf, row-major)
void ovqe_one_electron(int n_shells, const int32_t* ls, const double* centers,
                       const int32_t* nprim, const int32_t* prim_off,
                       const double* exps, const double* coefs,
                       int n_atoms, const double* atom_coords,
                       const double* charges,
                       int nbf, double* Sout, double* Tout, double* Vout) {
    auto shells = unpack_shells(n_shells, ls, centers, nprim, prim_off,
                                exps, coefs);
    std::vector<int> offs(n_shells);
    {
        int o = 0;
        for (int s = 0; s < n_shells; ++s) { offs[s] = o; o += ncart(shells[s].l); }
    }
    std::memset(Sout, 0, sizeof(double) * nbf * nbf);
    std::memset(Tout, 0, sizeof(double) * nbf * nbf);
    std::memset(Vout, 0, sizeof(double) * nbf * nbf);

    ShellPair sp;
    RArr R;
    for (int sa = 0; sa < n_shells; ++sa)
        for (int sb = 0; sb <= sa; ++sb) {
            const Shell& A = shells[sa];
            const Shell& B = shells[sb];
            build_pair(A, B, sp);
            const int na = ncart(A.l), nb_ = ncart(B.l);
            const int L = A.l + B.l;
            for (int ia = 0; ia < na; ++ia) {
                const int l1 = CART[A.l][ia][0], m1 = CART[A.l][ia][1],
                          n1_ = CART[A.l][ia][2];
                for (int ib = 0; ib < nb_; ++ib) {
                    const int l2 = CART[B.l][ib][0], m2 = CART[B.l][ib][1],
                              n2 = CART[B.l][ib][2];
                    double sval = 0.0, tval = 0.0, vval = 0.0;
                    int k = 0;
                    for (int i = 0; i < A.nprim; ++i)
                        for (int j = 0; j < B.nprim; ++j, ++k) {
                            const PairPrim& pp = sp.prims[k];
                            const double b = B.exps[j];
                            const double pref =
                                pp.coef * std::pow(M_PI / pp.p, 1.5);
                            const double sx = pp.Ex.v[l1][l2][0],
                                         sy = pp.Ey.v[m1][m2][0],
                                         sz = pp.Ez.v[n1_][n2][0];
                            sval += pref * sx * sy * sz;
                            tval += pref * (kin1d(pp.Ex, l1, l2, b) * sy * sz
                                            + sx * kin1d(pp.Ey, m1, m2, b) * sz
                                            + sx * sy * kin1d(pp.Ez, n1_, n2, b));
                            const double vpref = pp.coef * 2.0 * M_PI / pp.p;
                            for (int at = 0; at < n_atoms; ++at) {
                                hermite_coulomb(
                                    L, pp.p,
                                    pp.Px - atom_coords[3*at],
                                    pp.Py - atom_coords[3*at+1],
                                    pp.Pz - atom_coords[3*at+2], R);
                                double acc = 0.0;
                                for (int t = 0; t <= l1 + l2; ++t) {
                                    const double ex = pp.Ex.v[l1][l2][t];
                                    if (ex == 0.0) continue;
                                    for (int u = 0; u <= m1 + m2; ++u) {
                                        const double ey = pp.Ey.v[m1][m2][u];
                                        if (ey == 0.0) continue;
                                        for (int vv = 0; vv <= n1_ + n2; ++vv) {
                                            const double ez = pp.Ez.v[n1_][n2][vv];
                                            if (ez != 0.0)
                                                acc += ex * ey * ez * R.at(t, u, vv);
                                        }
                                    }
                                }
                                vval -= charges[at] * vpref * acc;
                            }
                        }
                    const int r = offs[sa] + ia, c = offs[sb] + ib;
                    Sout[r * nbf + c] = Sout[c * nbf + r] = sval;
                    Tout[r * nbf + c] = Tout[c * nbf + r] = tval;
                    Vout[r * nbf + c] = Vout[c * nbf + r] = vval;
                }
            }
        }
}

// full ERI tensor (pq|rs), chemist notation, 8-fold symmetry
void ovqe_eri(int n_shells, const int32_t* ls, const double* centers,
              const int32_t* nprim, const int32_t* prim_off,
              const double* exps, const double* coefs,
              int nbf, double* out) {
    auto shells = unpack_shells(n_shells, ls, centers, nprim, prim_off,
                                exps, coefs);
    std::vector<int> offs(n_shells);
    {
        int o = 0;
        for (int s = 0; s < n_shells; ++s) { offs[s] = o; o += ncart(shells[s].l); }
    }
    std::memset(out, 0, sizeof(double) * nbf * nbf * nbf * nbf);

    // precompute shell pairs (a >= b)
    std::vector<std::pair<int,int>> pairs;
    for (int a = 0; a < n_shells; ++a)
        for (int b = 0; b <= a; ++b) pairs.emplace_back(a, b);
    std::vector<ShellPair> sps(pairs.size());
    for (size_t i = 0; i < pairs.size(); ++i)
        build_pair(shells[pairs[i].first], shells[pairs[i].second], sps[i]);

    RArr R;
    std::vector<double> block;
    auto set8 = [&](int p, int q, int r, int s, double v) {
        out[((p * nbf + q) * nbf + r) * nbf + s] = v;
        out[((q * nbf + p) * nbf + r) * nbf + s] = v;
        out[((p * nbf + q) * nbf + s) * nbf + r] = v;
        out[((q * nbf + p) * nbf + s) * nbf + r] = v;
        out[((r * nbf + s) * nbf + p) * nbf + q] = v;
        out[((s * nbf + r) * nbf + p) * nbf + q] = v;
        out[((r * nbf + s) * nbf + q) * nbf + p] = v;
        out[((s * nbf + r) * nbf + q) * nbf + p] = v;
    };

    for (size_t ip = 0; ip < pairs.size(); ++ip) {
        const auto [isa, isb] = pairs[ip];
        const ShellPair& sp1 = sps[ip];
        const Shell &A = shells[isa], &B = shells[isb];
        const int na = ncart(A.l), nb_ = ncart(B.l);
        for (size_t jp = 0; jp <= ip; ++jp) {
            const auto [isc, isd] = pairs[jp];
            const ShellPair& sp2 = sps[jp];
            const Shell &C = shells[isc], &D = shells[isd];
            const int nc = ncart(C.l), nd = ncart(D.l);
            const int L = A.l + B.l + C.l + D.l;
            block.assign(na * nb_ * nc * nd, 0.0);

            for (int i = 0; i < A.nprim * B.nprim; ++i) {
                const PairPrim& pp = sp1.prims[i];
                for (int j = 0; j < C.nprim * D.nprim; ++j) {
                    const PairPrim& qq = sp2.prims[j];
                    const double p = pp.p, q = qq.p;
                    const double alpha = p * q / (p + q);
                    const double pref = pp.coef * qq.coef * 2.0 *
                        std::pow(M_PI, 2.5) / (p * q * std::sqrt(p + q));
                    hermite_coulomb(L, alpha, pp.Px - qq.Px, pp.Py - qq.Py,
                                    pp.Pz - qq.Pz, R);
                    int bi = 0;
                    for (int ia = 0; ia < na; ++ia) {
                        const int l1 = CART[A.l][ia][0], m1 = CART[A.l][ia][1],
                                  n1_ = CART[A.l][ia][2];
                        for (int ib = 0; ib < nb_; ++ib) {
                            const int l2 = CART[B.l][ib][0],
                                      m2 = CART[B.l][ib][1],
                                      n2 = CART[B.l][ib][2];
                            for (int ic = 0; ic < nc; ++ic) {
                                const int l3 = CART[C.l][ic][0],
                                          m3 = CART[C.l][ic][1],
                                          n3 = CART[C.l][ic][2];
                                for (int id = 0; id < nd; ++id, ++bi) {
                                    const int l4 = CART[D.l][id][0],
                                              m4 = CART[D.l][id][1],
                                              n4 = CART[D.l][id][2];
                                    double acc = 0.0;
                                    for (int t = 0; t <= l1 + l2; ++t) {
                                        const double e1x = pp.Ex.v[l1][l2][t];
                                        if (e1x == 0.0) continue;
                                        for (int u = 0; u <= m1 + m2; ++u) {
                                            const double e1y = pp.Ey.v[m1][m2][u];
                                            if (e1y == 0.0) continue;
                                            for (int v = 0; v <= n1_ + n2; ++v) {
                                                const double e1z = pp.Ez.v[n1_][n2][v];
                                                if (e1z == 0.0) continue;
                                                const double c1 = e1x * e1y * e1z;
                                                for (int tau = 0; tau <= l3 + l4; ++tau) {
                                                    const double e2x = qq.Ex.v[l3][l4][tau];
                                                    if (e2x == 0.0) continue;
                                                    for (int nu = 0; nu <= m3 + m4; ++nu) {
                                                        const double e2y = qq.Ey.v[m3][m4][nu];
                                                        if (e2y == 0.0) continue;
                                                        for (int ph = 0; ph <= n3 + n4; ++ph) {
                                                            const double e2z = qq.Ez.v[n3][n4][ph];
                                                            if (e2z == 0.0) continue;
                                                            const double sgn =
                                                                ((tau + nu + ph) & 1) ? -1.0 : 1.0;
                                                            acc += c1 * e2x * e2y * e2z * sgn *
                                                                R.at(t + tau, u + nu, v + ph);
                                                        }
                                                    }
                                                }
                                            }
                                        }
                                    }
                                    block[bi] += pref * acc;
                                }
                            }
                        }
                    }
                }
            }
            int bi = 0;
            for (int ia = 0; ia < na; ++ia)
                for (int ib = 0; ib < nb_; ++ib)
                    for (int ic = 0; ic < nc; ++ic)
                        for (int id = 0; id < nd; ++id, ++bi)
                            set8(offs[isa] + ia, offs[isb] + ib,
                                 offs[isc] + ic, offs[isd] + id, block[bi]);
        }
    }
}

}  // extern "C"
