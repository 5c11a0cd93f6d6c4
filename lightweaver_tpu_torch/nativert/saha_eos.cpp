// Native Saha-EOS core: damped charge-balance fixed point per point.
//
// The host-side runtime companion to eos.py (the role the reference's
// C++/numba EOS cores play for its Python layer; ref:
// lightweaver/wittmann.py:512-785).  The hydrostatic
// reconstruction in Atmosphere.make_1d calls the EOS point-by-point
// inside integration loops, which is the one genuinely hot host-side
// path in the framework; everything device-side goes through XLA.
//
// Build: g++ -O3 -shared -fPIC saha_eos.cpp -o libsaha_eos.so
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kB = 1.380658e-23;        // [J/K]
constexpr double hPlanck = 6.6260755e-34;  // [J s]
constexpr double mElectron = 9.1093897e-31;
constexpr double amu = 1.6605402e-27;
constexpr double eIonHmin = 1.208372e-19;  // 0.754 eV [J]

double interp(const double* xg, const double* yg, int n, double x)
{
    if (x <= xg[0]) return yg[0];
    if (x >= xg[n - 1]) return yg[n - 1];
    int lo = 0, hi = n - 1;
    while (hi - lo > 1)
    {
        int mid = (lo + hi) / 2;
        if (xg[mid] <= x) lo = mid; else hi = mid;
    }
    double f = (x - xg[lo]) / (xg[hi] - xg[lo]);
    return (1.0 - f) * yg[lo] + f * yg[hi];
}

// electrons donated per H nucleus at (T, ne), H- as a negative donor
double mean_charge(double T, double ne,
                   int Nelem, const int32_t* nStages,
                   const double* abund, const double* ionPot,
                   const double* Tpf, int Npf, const double* logU,
                   int maxStage)
{
    const double C1 = hPlanck / (2.0 * M_PI * mElectron)
                      * hPlanck / kB;
    const double CtNe = 2.0 * std::pow(C1 / T, -1.5) / ne;
    double eDonated = 0.0;
    double fH0 = 1.0;
    for (int el = 0; el < Nelem; ++el)
    {
        const int ns = nStages[el];
        const double* U = logU + el * maxStage * Npf;
        const double* chiIon = ionPot + el * maxStage;
        double fj[16];
        fj[0] = 1.0;
        double total = 1.0;
        double Uk = interp(Tpf, U, Npf, T);
        double weighted = 0.0;
        for (int j = 1; j < ns; ++j)
        {
            double Ukp1 = interp(Tpf, U + j * Npf, Npf, T);
            fj[j] = fj[j - 1] * CtNe
                    * std::exp(Ukp1 - Uk - chiIon[j - 1] / (kB * T));
            total += fj[j];
            weighted += j * fj[j];
            Uk = Ukp1;
        }
        eDonated += abund[el] * weighted / total;
        if (el == 0)          // hydrogen must be first
            fH0 = fj[0] / total;
    }
    const double CI = hPlanck / (2.0 * M_PI * mElectron)
                      * (hPlanck / kB);
    const double PhiHmin = 0.25 * std::pow(CI / T, 1.5)
                           * std::exp(eIonHmin / (kB * T));
    eDonated -= ne * PhiHmin * fH0;
    return eDonated;
}

}  // namespace

extern "C" {

// Solve the charge-balance fixed point for N (T, pgas) points.
// logU layout: [Nelem, maxStage, Npf]; ionPot: [Nelem, maxStage].
// Element 0 MUST be hydrogen.  Outputs: ne, nHTot, rho [N].
int saha_solve(const double* T, const double* pgas, int64_t N,
               int32_t Nelem, const int32_t* nStages,
               const double* abund, const double* ionPot,
               const double* Tpf, int32_t Npf, const double* logU,
               int32_t maxStage, double totalAbund, double massPerH,
               int32_t maxIter, double tol,
               double* neOut, double* nHTotOut, double* rhoOut)
{
    for (int64_t k = 0; k < N; ++k)
    {
        const double nTot = pgas[k] / (kB * T[k]);
        double ne = 1e-4 * nTot;
        for (int it = 0; it < maxIter; ++it)
        {
            const double nHTot = (nTot - ne) / totalAbund;
            double neNew = nHTot * mean_charge(
                T[k], std::max(ne, 1.0), Nelem, nStages, abund, ionPot,
                Tpf, Npf, logU, maxStage);
            if (neNew < 1e-8 * nTot) neNew = 1e-8 * nTot;
            if (neNew > 0.9 * nTot) neNew = 0.9 * nTot;
            const double change = std::fabs(neNew - ne)
                                  / std::max(neNew, 1e-30);
            ne = 0.5 * (ne + neNew);
            if (change < tol)
                break;
        }
        const double nHTot = (nTot - ne) / totalAbund;
        neOut[k] = ne;
        nHTotOut[k] = nHTot;
        rhoOut[k] = amu * massPerH * nHTot;
    }
    return 0;
}

}  // extern "C"
