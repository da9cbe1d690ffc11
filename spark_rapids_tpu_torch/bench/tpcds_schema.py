"""TPC-DS tables of the port's queries (copy of the parts of
spark_rapids_tpu/bench/tpcds_schema.py and spark_rapids_tpu/bench/tpcds.py
that the port's TPC-DS queries read).

date_dim, time_dim, item, store, store_sales, household_demographics,
customer_demographics and promotion (q3, q7, q42, q44, q52, q67, q96),
and store_returns, reason, catalog_sales, catalog_returns, web_sales,
customer and warehouse (q9, q28, q40, q43, q87, q88, q93, q97), and
customer_address, inventory, web_returns, catalog_page, web_site,
web_page, call_center, ship_mode and income_band (the breadth queries)
come from the same seeded generators as the reference's, so the tables
are equal bit for bit; money columns are retyped to decimal(7,2) as in the
official TPC-DS schema. All 24 tables of the reference's schema are
carried.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pyarrow as pa

# constants of spark_rapids_tpu/bench/tpcds.py
_N_DATES = 365 * 5  # 1998-2002, d_date_sk dense
_BASE_YEAR = 1998

_STATES = np.array(["TN", "GA", "TX", "CA", "OH", "IL", "VA", "NY", "KS",
                    "MI", "NC", "WA", "FL", "MO", "IN"])
_COUNTIES = np.array([f"{w} County" for w in
                      ["Williamson", "Ziebach", "Walker", "Daviess", "Luce",
                       "Huron", "Richland", "Gage", "Furnas", "Orange"]])
_CITIES = np.array(["Midway", "Fairview", "Oak Grove", "Five Points",
                    "Centerville", "Liberty", "Pleasant Hill", "Bethel",
                    "Union", "Salem"])
_COUNTRIES = np.array(["United States"])


def _money(rng, lo, hi, n):
    return np.round(rng.uniform(lo, hi, n), 2)


def n_items(sf: float) -> int:
    return max(int(18_000 * min(sf, 10.0)), 100)


def n_customers(sf: float) -> int:
    return max(int(100_000 * min(sf, 10.0)), 200)


def n_addresses(sf: float) -> int:
    return max(int(50_000 * min(sf, 10.0)), 100)


def n_warehouses(sf: float) -> int:
    return max(int(5 * np.sqrt(max(sf, 0.01))), 2)


def n_stores(sf: float) -> int:
    return max(int(12 * np.sqrt(max(sf, 0.01))), 2)


def gen_date_dim(seed: int = 0) -> pa.Table:
    sk = np.arange(1, _N_DATES + 1)
    year = _BASE_YEAR + (sk - 1) // 365
    doy = (sk - 1) % 365
    moy = np.minimum(doy // 30 + 1, 12)
    dom = doy % 30 + 1
    dow = (sk - 1) % 7
    day_names = np.array(["Sunday", "Monday", "Tuesday", "Wednesday",
                          "Thursday", "Friday", "Saturday"])
    # d_date as days since epoch (1998-01-01 = 10227)
    epoch = 10227 + (sk - 1)
    return pa.table({
        "d_date_sk": pa.array(sk, pa.int64()),
        "d_date_id": pa.array([f"D{int(s):09d}" for s in sk], pa.string()),
        "d_date": pa.array(epoch.astype(np.int32), pa.int32()).cast(
            pa.date32()),
        "d_year": pa.array(year.astype(np.int32), pa.int32()),
        "d_moy": pa.array(moy.astype(np.int32), pa.int32()),
        "d_dom": pa.array(dom.astype(np.int32), pa.int32()),
        "d_qoy": pa.array(((moy - 1) // 3 + 1).astype(np.int32), pa.int32()),
        "d_day_name": pa.array(day_names[dow], pa.string()),
        "d_week_seq": pa.array(((sk - 1) // 7 + 1).astype(np.int32),
                               pa.int32()),
        "d_month_seq": pa.array(((year - _BASE_YEAR) * 12 + moy - 1
                                 ).astype(np.int32), pa.int32()),
    })


def gen_item(sf: float, seed: int = 1) -> pa.Table:
    n = n_items(sf)
    rng = np.random.default_rng(seed)
    cats = np.array(["Books", "Home", "Electronics", "Jewelry", "Music",
                     "Shoes", "Sports", "Women", "Men", "Children"])
    # classes belong to their category (dsdgen hierarchy): picking them
    # independently can leave official (category, class) pairs like
    # Women/dresses empty at small scale
    cat_classes = {
        "Books": ["fiction", "history", "self-help", "romance"],
        "Home": ["accessories", "estate", "custom"],
        "Electronics": ["classical", "custom", "accessories"],
        "Jewelry": ["estate", "custom", "birdal"],
        "Music": ["classical", "romance"],
        "Shoes": ["pants", "custom"],
        "Sports": ["fishing", "golf"],
        "Women": ["dresses", "accessories", "birdal"],
        "Men": ["shirts", "pants", "accessories"],
        "Children": ["shirts", "pants"],
    }
    classes = np.array(["accessories", "classical", "fiction", "history",
                        "self-help", "fishing", "golf", "dresses", "pants",
                        "shirts", "birdal", "estate", "custom", "romance"])
    colors = np.array(["red", "blue", "green", "yellow", "purple", "white",
                       "black", "orange", "pink", "brown", "cyan", "smoke",
                       "saddle", "thistle", "lime", "frosted"])
    sizes = np.array(["small", "medium", "large", "extra large", "economy",
                      "N/A", "petite"])
    units = np.array(["Each", "Dozen", "Case", "Pound", "Oz", "Gross"])
    cat_id = rng.integers(0, len(cats), n)
    # vectorized per-category class pick: padded (n_cats, max_classes) LUT
    max_cls = max(len(v) for v in cat_classes.values())
    lut = np.zeros((len(cats), max_cls), np.int64)
    lut_n = np.zeros(len(cats), np.int64)
    for ci, c in enumerate(cats):
        idxs = [int(np.where(classes == cl)[0][0]) for cl in cat_classes[c]]
        lut[ci, : len(idxs)] = idxs
        lut_n[ci] = len(idxs)
    slot = (rng.random(n) * lut_n[cat_id]).astype(np.int64)
    class_id = lut[cat_id, slot]
    brand_id = rng.integers(1, 1000, n)
    manufact_id = rng.integers(1, 1000, n)
    cur = _money(rng, 0.5, 100.0, n)
    return pa.table({
        "i_item_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "i_item_id": pa.array([f"ITEM{j:08d}" for j in range(1, n + 1)],
                              pa.string()),
        "i_item_desc": pa.array([f"desc of item {j}" for j in range(1, n + 1)],
                                pa.string()),
        "i_brand_id": pa.array(brand_id, pa.int64()),
        "i_brand": pa.array([f"brand#{b}" for b in brand_id], pa.string()),
        "i_class_id": pa.array(class_id + 1, pa.int64()),
        "i_class": pa.array(classes[class_id], pa.string()),
        "i_category_id": pa.array(cat_id + 1, pa.int64()),
        "i_category": pa.array(cats[cat_id], pa.string()),
        "i_manufact_id": pa.array(manufact_id, pa.int64()),
        "i_manufact": pa.array([f"manufact#{m}" for m in manufact_id],
                               pa.string()),
        "i_manager_id": pa.array(rng.integers(1, 100, n), pa.int64()),
        "i_current_price": pa.array(cur, pa.float64()),
        "i_wholesale_cost": pa.array(np.round(cur * 0.6, 2), pa.float64()),
        "i_color": pa.array(colors[rng.integers(0, len(colors), n)],
                            pa.string()),
        "i_size": pa.array(sizes[rng.integers(0, len(sizes), n)], pa.string()),
        "i_units": pa.array(units[rng.integers(0, len(units), n)],
                            pa.string()),
        "i_product_name": pa.array([f"product{j}" for j in range(1, n + 1)],
                                   pa.string()),
    })


def gen_store(sf: float, seed: int = 2) -> pa.Table:
    n = n_stores(sf)
    rng = np.random.default_rng(seed)
    names = np.array(["ese", "ought", "able", "pri", "bar", "anti", "cally"])
    return pa.table({
        "s_store_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "s_store_id": pa.array([f"S{j:08d}" for j in range(1, n + 1)],
                               pa.string()),
        "s_store_name": pa.array(names[rng.integers(0, len(names), n)],
                                 pa.string()),
        # first store pinned to dsdgen's mode values so official query
        # constants (TN / Williamson County) always hit at every scale
        "s_state": pa.array(
            np.concatenate([["TN"], _STATES[rng.integers(
                0, len(_STATES), n - 1)]]) if n else [], pa.string()),
        "s_county": pa.array(
            np.concatenate([["Williamson County"], _COUNTIES[rng.integers(
                0, len(_COUNTIES), n - 1)]]) if n else [], pa.string()),
        "s_city": pa.array(_CITIES[rng.integers(0, len(_CITIES), n)],
                           pa.string()),
        "s_zip": pa.array([f"{z:05d}" for z in rng.integers(10000, 99999, n)],
                          pa.string()),
        "s_company_id": pa.array(np.ones(n, np.int64), pa.int64()),
        "s_company_name": pa.array(["Unknown"] * n, pa.string()),
        "s_number_employees": pa.array(
            rng.integers(200, 301, n).astype(np.int32), pa.int32()),
        "s_gmt_offset": pa.array(np.full(n, -5.0), pa.float64()),
    })


def _sales_common(rng, n, sf):
    qty = rng.integers(1, 101, n)
    wholesale = _money(rng, 1.0, 100.0, n)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, n), 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    ext_wholesale = np.round(wholesale * qty, 2)
    discount = np.round(ext_list - ext_sales, 2)
    tax = np.round(ext_sales * 0.08, 2)
    coupon = np.where(rng.random(n) < 0.2, _money(rng, 0, 50, n), 0.0)
    net_paid = np.round(ext_sales - coupon, 2)
    profit = np.round(net_paid - ext_wholesale, 2)
    return dict(qty=qty, wholesale=wholesale, list_price=list_price,
                sales_price=sales_price, ext_sales=ext_sales,
                ext_list=ext_list, ext_wholesale=ext_wholesale,
                discount=discount, tax=tax, coupon=coupon,
                net_paid=net_paid, profit=profit)


def gen_store_sales(sf: float, seed: int = 3) -> pa.Table:
    n = int(2_880_000 * sf)
    rng = np.random.default_rng(seed)
    c = _sales_common(rng, n, sf)
    # tickets: variable size 1..20, with date/time/customer/demo/addr/store
    # CONSTANT within a ticket (dsdgen models a basket the same way) — the
    # per-ticket count-band queries (q34 15..20, q73 1..5) need real baskets
    n_tick_est = n // 8 + 21
    sizes = rng.integers(1, 21, n_tick_est)
    tick_of_row = np.repeat(np.arange(len(sizes)), sizes)[:n]
    n_tick = int(tick_of_row[-1]) + 1 if n else 0

    def per_ticket(vals):
        return vals[tick_of_row]

    return pa.table({
        "ss_sold_date_sk": pa.array(per_ticket(
            rng.integers(1, _N_DATES + 1, n_tick)), pa.int64()),
        "ss_sold_time_sk": pa.array(per_ticket(
            rng.integers(0, 86400 // 60, n_tick) * 60), pa.int64()),
        "ss_item_sk": pa.array(rng.integers(1, n_items(sf) + 1, n),
                               pa.int64()),
        "ss_customer_sk": pa.array(per_ticket(
            rng.integers(1, n_customers(sf) + 1, n_tick)), pa.int64()),
        "ss_cdemo_sk": pa.array(per_ticket(
            rng.integers(1, 19_201, n_tick)), pa.int64()),
        "ss_hdemo_sk": pa.array(per_ticket(
            rng.integers(1, 7201, n_tick)), pa.int64()),
        "ss_addr_sk": pa.array(per_ticket(
            rng.integers(1, n_addresses(sf) + 1, n_tick)), pa.int64()),
        "ss_store_sk": pa.array(per_ticket(
            rng.integers(1, n_stores(sf) + 1, n_tick)), pa.int64()),
        "ss_promo_sk": pa.array(rng.integers(1, 301, n), pa.int64()),
        "ss_ticket_number": pa.array(tick_of_row + 1, pa.int64()),
        "ss_quantity": pa.array(c["qty"].astype(np.float64), pa.float64()),
        "ss_wholesale_cost": pa.array(c["wholesale"], pa.float64()),
        "ss_list_price": pa.array(c["list_price"], pa.float64()),
        "ss_sales_price": pa.array(c["sales_price"], pa.float64()),
        "ss_ext_discount_amt": pa.array(c["discount"], pa.float64()),
        "ss_ext_sales_price": pa.array(c["ext_sales"], pa.float64()),
        "ss_ext_wholesale_cost": pa.array(c["ext_wholesale"], pa.float64()),
        "ss_ext_list_price": pa.array(c["ext_list"], pa.float64()),
        "ss_ext_tax": pa.array(c["tax"], pa.float64()),
        "ss_coupon_amt": pa.array(c["coupon"], pa.float64()),
        "ss_net_paid": pa.array(c["net_paid"], pa.float64()),
        "ss_net_paid_inc_tax": pa.array(
            np.round(c["net_paid"] + c["tax"], 2), pa.float64()),
        "ss_net_profit": pa.array(c["profit"], pa.float64()),
    })


def gen_time_dim() -> pa.Table:
    sk = np.arange(0, 86400, 60)  # one row per minute
    hours = sk // 3600
    shift = np.select([hours < 12, hours < 17, hours < 21],
                      ["morning", "afternoon", "evening"], "night")
    return pa.table({
        "t_time_sk": pa.array(sk, pa.int64()),
        "t_time": pa.array(sk.astype(np.int32), pa.int32()),
        "t_hour": pa.array(hours.astype(np.int32), pa.int32()),
        "t_minute": pa.array((sk % 3600 // 60).astype(np.int32), pa.int32()),
        "t_meal_time": pa.array(
            np.select([(hours >= 6) & (hours <= 8),
                       (hours >= 11) & (hours <= 13),
                       (hours >= 17) & (hours <= 19)],
                      ["breakfast", "lunch", "dinner"], None), pa.string()),
        "t_shift": pa.array(shift, pa.string()),
    })


def gen_household_demographics(seed: int = 11) -> pa.Table:
    n = 7200
    rng = np.random.default_rng(seed)
    pot = np.array([">10000", "5001-10000", "1001-5000", "501-1000",
                    "0-500", "Unknown"])
    return pa.table({
        "hd_demo_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "hd_income_band_sk": pa.array(rng.integers(1, 21, n), pa.int64()),
        "hd_buy_potential": pa.array(pot[rng.integers(0, len(pot), n)],
                                     pa.string()),
        "hd_dep_count": pa.array(rng.integers(0, 10, n).astype(np.int32),
                                 pa.int32()),
        "hd_vehicle_count": pa.array(rng.integers(-1, 5, n).astype(np.int32),
                                     pa.int32()),
    })


def gen_promotion(seed: int = 13) -> pa.Table:
    n = 300
    rng = np.random.default_rng(seed)
    yn = np.array(["Y", "N"])
    return pa.table({
        "p_promo_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "p_promo_id": pa.array([f"P{j:08d}" for j in range(1, n + 1)],
                               pa.string()),
        "p_channel_email": pa.array(yn[rng.integers(0, 2, n)], pa.string()),
        "p_channel_event": pa.array(yn[rng.integers(0, 2, n)], pa.string()),
        "p_channel_dmail": pa.array(yn[rng.integers(0, 2, n)], pa.string()),
        "p_channel_tv": pa.array(yn[rng.integers(0, 2, n)], pa.string()),
    })


def gen_customer_demographics() -> pa.Table:
    """Copy of spark_rapids_tpu/bench/tpcds.py's generator (seed 12)."""
    n = 19_200
    rng = np.random.default_rng(12)
    genders = np.array(["M", "F"])
    marital = np.array(["S", "M", "D", "W", "U"])
    edu = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                    "4 yr Degree", "Advanced Degree", "Unknown"])
    return pa.table({
        "cd_demo_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "cd_gender": pa.array(genders[rng.integers(0, 2, n)], pa.string()),
        "cd_marital_status": pa.array(marital[rng.integers(0, 5, n)],
                                      pa.string()),
        "cd_education_status": pa.array(edu[rng.integers(0, 7, n)],
                                        pa.string()),
        "cd_dep_count": pa.array(rng.integers(0, 7, n).astype(np.int32),
                                 pa.int32()),
    })


def gen_customer(sf: float, seed: int = 21) -> pa.Table:
    n = n_customers(sf)
    rng = np.random.default_rng(seed)
    firsts = np.array(["James", "Mary", "John", "Linda", "Robert", "Susan",
                       "Michael", "Karen", "William", "Lisa"])
    lasts = np.array(["Smith", "Jones", "Brown", "Davis", "Miller", "Wilson",
                      "Moore", "Taylor", "Clark", "Hall"])
    countries = np.array(["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                          "FRANCE", "JAPAN"])
    yn = np.array(["Y", "N"])
    return pa.table({
        "c_customer_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "c_customer_id": pa.array([f"C{j:012d}" for j in range(1, n + 1)],
                                  pa.string()),
        "c_first_name": pa.array(firsts[rng.integers(0, len(firsts), n)],
                                 pa.string()),
        "c_last_name": pa.array(lasts[rng.integers(0, len(lasts), n)],
                                pa.string()),
        "c_preferred_cust_flag": pa.array(yn[rng.integers(0, 2, n)],
                                          pa.string()),
        "c_birth_month": pa.array(rng.integers(1, 13, n).astype(np.int32),
                                  pa.int32()),
        "c_birth_year": pa.array(
            rng.integers(1924, 1993, n).astype(np.int32), pa.int32()),
        "c_birth_country": pa.array(
            countries[rng.integers(0, len(countries), n)], pa.string()),
        "c_current_addr_sk": pa.array(
            rng.integers(1, n_addresses(sf) + 1, n), pa.int64()),
        "c_current_cdemo_sk": pa.array(rng.integers(1, 19_201, n), pa.int64()),
        "c_current_hdemo_sk": pa.array(rng.integers(1, 7201, n), pa.int64()),
        "c_email_address": pa.array(
            [f"c{j}@example.com" for j in range(1, n + 1)], pa.string()),
        "c_salutation": pa.array(
            np.array(["Mr.", "Ms.", "Dr.", "Mrs.", "Sir"])[
                rng.integers(0, 5, n)], pa.string()),
        "c_login": pa.array([f"login{j}" for j in range(1, n + 1)],
                            pa.string()),
        "c_first_sales_date_sk": pa.array(
            rng.integers(1, _N_DATES + 1, n), pa.int64()),
        "c_first_shipto_date_sk": pa.array(
            rng.integers(1, _N_DATES + 1, n), pa.int64()),
    })


def gen_reason(seed: int = 14) -> pa.Table:
    descs = ["Package was damaged", "Stopped working", "Did not like the",
             "Wrong size", "Not the product that", "Parts missing",
             "Does not work with", "Gift exchange", "Did not fit",
             "Found a better price", "Was too expensive", "unknown"]
    n = len(descs)
    return pa.table({
        "r_reason_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "r_reason_desc": pa.array(descs, pa.string()),
    })


def gen_warehouse(sf: float, seed: int = 15) -> pa.Table:
    n = n_warehouses(sf)
    rng = np.random.default_rng(seed)
    return pa.table({
        "w_warehouse_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "w_warehouse_name": pa.array([f"Warehouse {j}" for j in range(1, n + 1)],
                                     pa.string()),
        "w_warehouse_sq_ft": pa.array(
            rng.integers(50_000, 1_000_000, n).astype(np.int32), pa.int32()),
        "w_state": pa.array(_STATES[rng.integers(0, len(_STATES), n)],
                            pa.string()),
        "w_county": pa.array(_COUNTIES[rng.integers(0, len(_COUNTIES), n)],
                             pa.string()),
        "w_city": pa.array(_CITIES[rng.integers(0, len(_CITIES), n)],
                           pa.string()),
    })


def gen_customer_address(sf: float, seed: int = 20) -> pa.Table:
    n = n_addresses(sf)
    rng = np.random.default_rng(seed)
    loc = np.array(["apartment", "condo", "single family"])
    return pa.table({
        "ca_address_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "ca_address_id": pa.array([f"A{j:08d}" for j in range(1, n + 1)],
                                  pa.string()),
        "ca_state": pa.array(_STATES[rng.integers(0, len(_STATES), n)],
                             pa.string()),
        "ca_county": pa.array(_COUNTIES[rng.integers(0, len(_COUNTIES), n)],
                              pa.string()),
        "ca_city": pa.array(_CITIES[rng.integers(0, len(_CITIES), n)],
                            pa.string()),
        "ca_zip": pa.array([f"{z:05d}" for z in rng.integers(10000, 99999, n)],
                           pa.string()),
        "ca_country": pa.array(
            _COUNTRIES[rng.integers(0, len(_COUNTRIES), n)], pa.string()),
        "ca_gmt_offset": pa.array(
            rng.choice([-5.0, -6.0, -7.0, -8.0], n), pa.float64()),
        "ca_location_type": pa.array(loc[rng.integers(0, len(loc), n)],
                                     pa.string()),
        "ca_street_name": pa.array(
            [f"{w} St" for w in _CITIES[rng.integers(0, len(_CITIES), n)]],
            pa.string()),
        "ca_street_number": pa.array(
            [str(x) for x in rng.integers(1, 1000, n)], pa.string()),
        "ca_suite_number": pa.array(
            [f"Suite {x}" for x in rng.integers(1, 100, n)], pa.string()),
    })


def gen_income_band() -> pa.Table:
    sk = np.arange(1, 21)
    lo = (sk - 1) * 10_000
    return pa.table({
        "ib_income_band_sk": pa.array(sk, pa.int64()),
        "ib_lower_bound": pa.array(lo.astype(np.int32), pa.int32()),
        "ib_upper_bound": pa.array((lo + 9999).astype(np.int32), pa.int32()),
    })


def gen_ship_mode() -> pa.Table:
    types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
             "LIBRARY"]
    carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "LATVIAN"]
    n = len(types)
    return pa.table({
        "sm_ship_mode_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "sm_type": pa.array(types, pa.string()),
        "sm_carrier": pa.array(carriers, pa.string()),
        "sm_code": pa.array(["AIR"] * n, pa.string()),
    })


def gen_web_site(seed: int = 16) -> pa.Table:
    n = 24
    rng = np.random.default_rng(seed)
    return pa.table({
        "web_site_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "web_site_id": pa.array([f"W{j:08d}" for j in range(1, n + 1)],
                                pa.string()),
        "web_name": pa.array([f"site_{j % 4}" for j in range(n)], pa.string()),
        "web_company_name": pa.array(
            np.array(["pri", "ought", "able", "ese"])[rng.integers(0, 4, n)],
            pa.string()),
    })


def gen_web_page(seed: int = 17) -> pa.Table:
    n = 60
    rng = np.random.default_rng(seed)
    return pa.table({
        "wp_web_page_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "wp_char_count": pa.array(
            rng.integers(100, 8000, n).astype(np.int32), pa.int32()),
    })


def gen_call_center(seed: int = 18) -> pa.Table:
    n = 6
    rng = np.random.default_rng(seed)
    return pa.table({
        "cc_call_center_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "cc_call_center_id": pa.array([f"CC{j:06d}" for j in range(1, n + 1)],
                                      pa.string()),
        "cc_name": pa.array([f"call center {j}" for j in range(1, n + 1)],
                            pa.string()),
        "cc_county": pa.array(_COUNTIES[rng.integers(0, len(_COUNTIES), n)],
                              pa.string()),
        "cc_manager": pa.array([f"Manager {j}" for j in range(1, n + 1)],
                               pa.string()),
    })


def gen_catalog_page(seed: int = 19) -> pa.Table:
    n = 11_000
    rng = np.random.default_rng(seed)
    return pa.table({
        "cp_catalog_page_sk": pa.array(np.arange(1, n + 1), pa.int64()),
        "cp_catalog_page_id": pa.array(
            [f"CP{j:010d}" for j in range(1, n + 1)], pa.string()),
        "cp_catalog_page_number": pa.array(
            rng.integers(1, 109, n).astype(np.int32), pa.int32()),
    })


def gen_store_returns(sf: float, store_sales: pa.Table,
                      seed: int = 4) -> pa.Table:
    rng = np.random.default_rng(seed)
    n_s = store_sales.num_rows
    n = max(n_s // 10, 10)
    pick = rng.integers(0, n_s, n)
    item = store_sales.column("ss_item_sk").to_numpy()[pick]
    ticket = store_sales.column("ss_ticket_number").to_numpy()[pick]
    cust = store_sales.column("ss_customer_sk").to_numpy()[pick]
    store = store_sales.column("ss_store_sk").to_numpy()[pick]
    # returns happen 1-90 days AFTER the sale (dsdgen ties them the same
    # way; random dates starve bought-then-returned window chains like q25)
    sold = store_sales.column("ss_sold_date_sk").to_numpy()[pick]
    ret_date = np.minimum(sold + rng.integers(1, 91, n), _N_DATES)
    qty = rng.integers(1, 51, n)
    amt = _money(rng, 1.0, 300.0, n)
    return pa.table({
        "sr_returned_date_sk": pa.array(ret_date, pa.int64()),
        "sr_item_sk": pa.array(item, pa.int64()),
        "sr_customer_sk": pa.array(cust, pa.int64()),
        "sr_cdemo_sk": pa.array(rng.integers(1, 19_201, n), pa.int64()),
        "sr_hdemo_sk": pa.array(rng.integers(1, 7201, n), pa.int64()),
        "sr_addr_sk": pa.array(rng.integers(1, n_addresses(sf) + 1, n),
                               pa.int64()),
        "sr_store_sk": pa.array(store, pa.int64()),
        "sr_reason_sk": pa.array(rng.integers(1, 13, n), pa.int64()),
        "sr_ticket_number": pa.array(ticket, pa.int64()),
        "sr_return_quantity": pa.array(qty.astype(np.float64), pa.float64()),
        "sr_return_amt": pa.array(amt, pa.float64()),
        "sr_return_tax": pa.array(np.round(amt * 0.08, 2), pa.float64()),
        "sr_return_amt_inc_tax": pa.array(np.round(amt * 1.08, 2),
                                          pa.float64()),
        "sr_fee": pa.array(_money(rng, 0.5, 100.0, n), pa.float64()),
        "sr_return_ship_cost": pa.array(_money(rng, 0, 50, n), pa.float64()),
        "sr_refunded_cash": pa.array(np.round(amt * 0.8, 2), pa.float64()),
        "sr_reversed_charge": pa.array(np.round(amt * 0.1, 2), pa.float64()),
        "sr_store_credit": pa.array(np.round(amt * 0.1, 2), pa.float64()),
        "sr_net_loss": pa.array(_money(rng, 0.5, 200.0, n), pa.float64()),
    })


def _correlate_baskets(rng, n: int, cust: np.ndarray, item: np.ndarray,
                       basket: Optional[pa.Table], cust_col: str,
                       item_col: str, frac: float = 0.25):
    """Overwrite a fraction of (customer, item) pairs with pairs drawn from
    another channel's sales — dsdgen models repeat customers the same way;
    without it, cross-channel chains (q25/q29/q54/q64: bought in store,
    returned, re-bought via catalog) are empty at small scale."""
    if basket is None or n == 0 or basket.num_rows == 0:
        return cust, item
    k = int(n * frac)
    idx = rng.choice(n, size=k, replace=False)
    pick = rng.integers(0, basket.num_rows, k)
    cust = cust.copy()
    item = item.copy()
    cust[idx] = basket.column(cust_col).to_numpy()[pick]
    item[idx] = basket.column(item_col).to_numpy()[pick]
    return cust, item


def gen_catalog_sales(sf: float, seed: int = 5,
                      basket: Optional[pa.Table] = None,
                      basket_cols=("ss_customer_sk", "ss_item_sk")
                      ) -> pa.Table:
    n = int(1_440_000 * sf)
    rng = np.random.default_rng(seed)
    c = _sales_common(rng, n, sf)
    ship_date = rng.integers(1, _N_DATES + 1, n)
    bill_cust, cs_item = _correlate_baskets(
        rng, n, rng.integers(1, n_customers(sf) + 1, n),
        rng.integers(1, n_items(sf) + 1, n), basket,
        basket_cols[0], basket_cols[1])
    return pa.table({
        "cs_sold_date_sk": pa.array(rng.integers(1, _N_DATES + 1, n),
                                    pa.int64()),
        "cs_sold_time_sk": pa.array(rng.integers(0, 86400 // 60, n) * 60,
                                    pa.int64()),
        "cs_ship_date_sk": pa.array(ship_date, pa.int64()),
        "cs_bill_customer_sk": pa.array(bill_cust, pa.int64()),
        "cs_bill_cdemo_sk": pa.array(rng.integers(1, 19_201, n), pa.int64()),
        "cs_bill_hdemo_sk": pa.array(rng.integers(1, 7201, n), pa.int64()),
        "cs_bill_addr_sk": pa.array(rng.integers(1, n_addresses(sf) + 1, n),
                                    pa.int64()),
        "cs_ship_customer_sk": pa.array(
            rng.integers(1, n_customers(sf) + 1, n), pa.int64()),
        "cs_ship_addr_sk": pa.array(rng.integers(1, n_addresses(sf) + 1, n),
                                    pa.int64()),
        "cs_ship_mode_sk": pa.array(rng.integers(1, 7, n), pa.int64()),
        "cs_call_center_sk": pa.array(rng.integers(1, 7, n), pa.int64()),
        "cs_catalog_page_sk": pa.array(rng.integers(1, 11_001, n), pa.int64()),
        "cs_warehouse_sk": pa.array(
            rng.integers(1, n_warehouses(sf) + 1, n), pa.int64()),
        "cs_item_sk": pa.array(cs_item, pa.int64()),
        "cs_promo_sk": pa.array(rng.integers(1, 301, n), pa.int64()),
        "cs_order_number": pa.array(np.arange(1, n + 1) // 4 + 1, pa.int64()),
        "cs_quantity": pa.array(c["qty"].astype(np.float64), pa.float64()),
        "cs_wholesale_cost": pa.array(c["wholesale"], pa.float64()),
        "cs_list_price": pa.array(c["list_price"], pa.float64()),
        "cs_sales_price": pa.array(c["sales_price"], pa.float64()),
        "cs_ext_discount_amt": pa.array(c["discount"], pa.float64()),
        "cs_ext_sales_price": pa.array(c["ext_sales"], pa.float64()),
        "cs_ext_wholesale_cost": pa.array(c["ext_wholesale"], pa.float64()),
        "cs_ext_list_price": pa.array(c["ext_list"], pa.float64()),
        "cs_ext_tax": pa.array(c["tax"], pa.float64()),
        "cs_coupon_amt": pa.array(c["coupon"], pa.float64()),
        "cs_ext_ship_cost": pa.array(_money(rng, 0, 100, n), pa.float64()),
        "cs_net_paid": pa.array(c["net_paid"], pa.float64()),
        "cs_net_paid_inc_tax": pa.array(
            np.round(c["net_paid"] + c["tax"], 2), pa.float64()),
        "cs_net_profit": pa.array(c["profit"], pa.float64()),
    })


def gen_catalog_returns(sf: float, catalog_sales: pa.Table,
                        seed: int = 6) -> pa.Table:
    rng = np.random.default_rng(seed)
    n_s = catalog_sales.num_rows
    n = max(n_s // 10, 10)
    pick = rng.integers(0, n_s, n)
    item = catalog_sales.column("cs_item_sk").to_numpy()[pick]
    order = catalog_sales.column("cs_order_number").to_numpy()[pick]
    cust = catalog_sales.column("cs_bill_customer_sk").to_numpy()[pick]
    qty = rng.integers(1, 51, n)
    amt = _money(rng, 1.0, 300.0, n)
    return pa.table({
        "cr_returned_date_sk": pa.array(rng.integers(1, _N_DATES + 1, n),
                                        pa.int64()),
        "cr_item_sk": pa.array(item, pa.int64()),
        "cr_refunded_customer_sk": pa.array(cust, pa.int64()),
        "cr_returning_customer_sk": pa.array(cust, pa.int64()),
        "cr_returning_addr_sk": pa.array(
            rng.integers(1, n_addresses(sf) + 1, n), pa.int64()),
        "cr_call_center_sk": pa.array(rng.integers(1, 7, n), pa.int64()),
        "cr_catalog_page_sk": pa.array(rng.integers(1, 11_001, n), pa.int64()),
        "cr_reason_sk": pa.array(rng.integers(1, 13, n), pa.int64()),
        "cr_order_number": pa.array(order, pa.int64()),
        "cr_return_quantity": pa.array(qty.astype(np.float64), pa.float64()),
        "cr_return_amount": pa.array(amt, pa.float64()),
        "cr_return_amt_inc_tax": pa.array(np.round(amt * 1.08, 2),
                                          pa.float64()),
        "cr_fee": pa.array(_money(rng, 0.5, 100.0, n), pa.float64()),
        "cr_return_ship_cost": pa.array(_money(rng, 0, 50, n), pa.float64()),
        "cr_refunded_cash": pa.array(np.round(amt * 0.8, 2), pa.float64()),
        "cr_reversed_charge": pa.array(np.round(amt * 0.1, 2), pa.float64()),
        "cr_store_credit": pa.array(np.round(amt * 0.1, 2), pa.float64()),
        "cr_net_loss": pa.array(_money(rng, 0.5, 200.0, n), pa.float64()),
    })


def gen_web_sales(sf: float, seed: int = 7,
                  basket: Optional[pa.Table] = None) -> pa.Table:
    n = int(720_000 * sf)
    rng = np.random.default_rng(seed)
    c = _sales_common(rng, n, sf)
    bill_cust, ws_item = _correlate_baskets(
        rng, n, rng.integers(1, n_customers(sf) + 1, n),
        rng.integers(1, n_items(sf) + 1, n), basket,
        "ss_customer_sk", "ss_item_sk")
    return pa.table({
        "ws_sold_date_sk": pa.array(rng.integers(1, _N_DATES + 1, n),
                                    pa.int64()),
        "ws_sold_time_sk": pa.array(rng.integers(0, 86400 // 60, n) * 60,
                                    pa.int64()),
        "ws_ship_date_sk": pa.array(rng.integers(1, _N_DATES + 1, n),
                                    pa.int64()),
        "ws_item_sk": pa.array(ws_item, pa.int64()),
        "ws_bill_customer_sk": pa.array(bill_cust, pa.int64()),
        "ws_bill_cdemo_sk": pa.array(rng.integers(1, 19_201, n), pa.int64()),
        "ws_bill_hdemo_sk": pa.array(rng.integers(1, 7201, n), pa.int64()),
        "ws_bill_addr_sk": pa.array(rng.integers(1, n_addresses(sf) + 1, n),
                                    pa.int64()),
        "ws_ship_customer_sk": pa.array(
            rng.integers(1, n_customers(sf) + 1, n), pa.int64()),
        "ws_ship_addr_sk": pa.array(rng.integers(1, n_addresses(sf) + 1, n),
                                    pa.int64()),
        "ws_web_page_sk": pa.array(rng.integers(1, 61, n), pa.int64()),
        "ws_web_site_sk": pa.array(rng.integers(1, 25, n), pa.int64()),
        "ws_ship_mode_sk": pa.array(rng.integers(1, 7, n), pa.int64()),
        "ws_warehouse_sk": pa.array(
            rng.integers(1, n_warehouses(sf) + 1, n), pa.int64()),
        "ws_promo_sk": pa.array(rng.integers(1, 301, n), pa.int64()),
        "ws_order_number": pa.array(np.arange(1, n + 1) // 4 + 1, pa.int64()),
        "ws_quantity": pa.array(c["qty"].astype(np.float64), pa.float64()),
        "ws_wholesale_cost": pa.array(c["wholesale"], pa.float64()),
        "ws_list_price": pa.array(c["list_price"], pa.float64()),
        "ws_sales_price": pa.array(c["sales_price"], pa.float64()),
        "ws_ext_discount_amt": pa.array(c["discount"], pa.float64()),
        "ws_ext_sales_price": pa.array(c["ext_sales"], pa.float64()),
        "ws_ext_wholesale_cost": pa.array(c["ext_wholesale"], pa.float64()),
        "ws_ext_list_price": pa.array(c["ext_list"], pa.float64()),
        "ws_ext_tax": pa.array(c["tax"], pa.float64()),
        "ws_coupon_amt": pa.array(c["coupon"], pa.float64()),
        "ws_ext_ship_cost": pa.array(_money(rng, 0, 100, n), pa.float64()),
        "ws_net_paid": pa.array(c["net_paid"], pa.float64()),
        "ws_net_paid_inc_tax": pa.array(
            np.round(c["net_paid"] + c["tax"], 2), pa.float64()),
        "ws_net_profit": pa.array(c["profit"], pa.float64()),
    })


def gen_web_returns(sf: float, web_sales: pa.Table, seed: int = 8) -> pa.Table:
    rng = np.random.default_rng(seed)
    n_s = web_sales.num_rows
    n = max(n_s // 10, 10)
    pick = rng.integers(0, n_s, n)
    item = web_sales.column("ws_item_sk").to_numpy()[pick]
    order = web_sales.column("ws_order_number").to_numpy()[pick]
    cust = web_sales.column("ws_bill_customer_sk").to_numpy()[pick]
    qty = rng.integers(1, 51, n)
    amt = _money(rng, 1.0, 300.0, n)
    return pa.table({
        "wr_returned_date_sk": pa.array(rng.integers(1, _N_DATES + 1, n),
                                        pa.int64()),
        "wr_item_sk": pa.array(item, pa.int64()),
        "wr_refunded_customer_sk": pa.array(cust, pa.int64()),
        "wr_returning_customer_sk": pa.array(cust, pa.int64()),
        "wr_returning_addr_sk": pa.array(
            rng.integers(1, n_addresses(sf) + 1, n), pa.int64()),
        "wr_refunded_addr_sk": pa.array(
            rng.integers(1, n_addresses(sf) + 1, n), pa.int64()),
        "wr_web_page_sk": pa.array(rng.integers(1, 61, n), pa.int64()),
        "wr_reason_sk": pa.array(rng.integers(1, 13, n), pa.int64()),
        "wr_order_number": pa.array(order, pa.int64()),
        "wr_return_quantity": pa.array(qty.astype(np.float64), pa.float64()),
        "wr_return_amt": pa.array(amt, pa.float64()),
        "wr_fee": pa.array(_money(rng, 0.5, 100.0, n), pa.float64()),
        "wr_refunded_cash": pa.array(np.round(amt * 0.8, 2), pa.float64()),
        "wr_net_loss": pa.array(_money(rng, 0.5, 200.0, n), pa.float64()),
    })


def gen_inventory(sf: float, seed: int = 9) -> pa.Table:
    # weekly snapshots: dates every 7 days x items x warehouses (capped)
    rng = np.random.default_rng(seed)
    dates = np.arange(1, _N_DATES + 1, 7)
    items = np.arange(1, n_items(sf) + 1)
    whs = np.arange(1, n_warehouses(sf) + 1)
    # cap the cross product for test scales
    max_rows = int(2_000_000 * max(sf, 0.01))
    total = len(dates) * len(items) * len(whs)
    if total > max_rows:
        items = items[: max(max_rows // (len(dates) * len(whs)), 1)]
        total = len(dates) * len(items) * len(whs)
    d, i, w = np.meshgrid(dates, items, whs, indexing="ij")
    return pa.table({
        "inv_date_sk": pa.array(d.ravel(), pa.int64()),
        "inv_item_sk": pa.array(i.ravel(), pa.int64()),
        "inv_warehouse_sk": pa.array(w.ravel(), pa.int64()),
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1000, total).astype(np.int32), pa.int32()),
    })


_MONEY_TOKENS = ("price", "cost", "amt", "tax", "paid", "profit", "fee",
                 "credit", "charge", "cash", "coupon", "commission")


def _decimalize(table: pa.Table) -> pa.Table:
    """Retype money columns float64 -> decimal(7,2), the official TPC-DS
    typing (tpcds.sql: ss_sales_price decimal(7,2) etc.).  Generated values
    are pre-rounded to 2dp so the cast is exact; this is what makes money
    aggregation bit-identical across engines (float sums are
    summation-order-dependent — round-2 q44)."""
    for i, name in enumerate(table.column_names):
        f = table.field(i)
        if f.type == pa.float64() and any(tok in name
                                          for tok in _MONEY_TOKENS):
            col = table.column(i).cast(pa.decimal128(7, 2))
            table = table.set_column(i, pa.field(name, col.type), col)
    return table


BASE_TABLES = ("date_dim", "time_dim", "item", "store",
               "customer_demographics", "household_demographics",
               "promotion", "store_sales")
JOIN_TABLES = ("store_returns", "reason", "catalog_sales",
               "catalog_returns", "web_sales", "customer", "warehouse")
BREADTH_TABLES = ("customer_address", "inventory", "web_returns",
                  "catalog_page", "web_site", "web_page", "call_center",
                  "ship_mode", "income_band")
ALL_TABLES = BASE_TABLES + JOIN_TABLES + BREADTH_TABLES


def tables_for(sf: float, seed: int = 0,
               names=BASE_TABLES) -> Dict[str, pa.Table]:
    """The named tables (by default the eight of q3-q96) at scale factor
    ``sf``, with the seeds the reference's ``tables_for`` passes (date_dim
    ``seed``, item ``seed + 1``, store ``seed + 2``, store_sales ``seed +
    3``, store_returns ``seed + 4``, catalog_sales ``seed + 5`` with the
    store_returns basket, catalog_returns ``seed + 6``, web_sales ``seed +
    7`` with the store_sales basket, web_returns ``seed + 8``, inventory
    ``seed + 9``, promotion ``seed + 13``, warehouse ``seed + 15``,
    customer_address ``seed + 20``, customer ``seed + 21``; time_dim,
    reason, customer_demographics, household_demographics, income_band,
    ship_mode, web_site, web_page, call_center and catalog_page fixed) and
    money columns as decimal(7,2). A fact table that another is drawn from
    is generated for it, but returned only when named."""
    names = tuple(names)
    unknown = set(names) - set(ALL_TABLES)
    if unknown:
        raise KeyError(f"tables not carried by the port: {sorted(unknown)}")
    made: Dict[str, pa.Table] = {}

    def get(name: str) -> pa.Table:
        if name not in made:
            made[name] = _GENERATORS[name](sf, seed, get)
        return made[name]

    return {k: _decimalize(get(k)) for k in names}


# name -> (sf, seed, get) -> table; ``get`` gives a table it is drawn from
_GENERATORS = {
    "date_dim": lambda sf, seed, get: gen_date_dim(seed),
    "time_dim": lambda sf, seed, get: gen_time_dim(),
    "item": lambda sf, seed, get: gen_item(sf, seed + 1),
    "store": lambda sf, seed, get: gen_store(sf, seed + 2),
    "customer_demographics": lambda sf, seed, get:
        gen_customer_demographics(),
    "household_demographics": lambda sf, seed, get:
        gen_household_demographics(),
    "promotion": lambda sf, seed, get: gen_promotion(seed + 13),
    "store_sales": lambda sf, seed, get: gen_store_sales(sf, seed + 3),
    "store_returns": lambda sf, seed, get: gen_store_returns(
        sf, get("store_sales"), seed + 4),
    # catalog re-buys correlate with returned store pairs, web buys with
    # store sales (the reference's baskets)
    "catalog_sales": lambda sf, seed, get: gen_catalog_sales(
        sf, seed + 5, basket=get("store_returns"),
        basket_cols=("sr_customer_sk", "sr_item_sk")),
    "catalog_returns": lambda sf, seed, get: gen_catalog_returns(
        sf, get("catalog_sales"), seed + 6),
    "web_sales": lambda sf, seed, get: gen_web_sales(
        sf, seed + 7, basket=get("store_sales")),
    "reason": lambda sf, seed, get: gen_reason(),
    "warehouse": lambda sf, seed, get: gen_warehouse(sf, seed + 15),
    "customer": lambda sf, seed, get: gen_customer(sf, seed + 21),
    "customer_address": lambda sf, seed, get: gen_customer_address(
        sf, seed + 20),
    "inventory": lambda sf, seed, get: gen_inventory(sf, seed + 9),
    "web_returns": lambda sf, seed, get: gen_web_returns(
        sf, get("web_sales"), seed + 8),
    "catalog_page": lambda sf, seed, get: gen_catalog_page(),
    "web_site": lambda sf, seed, get: gen_web_site(),
    "web_page": lambda sf, seed, get: gen_web_page(),
    "call_center": lambda sf, seed, get: gen_call_center(),
    "ship_mode": lambda sf, seed, get: gen_ship_mode(),
    "income_band": lambda sf, seed, get: gen_income_band(),
}
